"""The client side of a cell: the port's continuous-batching engine
(``repro_torch.serve.ServeEngine``) built on the benchmark's weights and
the cell's bucket grid, warmed, then driven by closed-loop clients.

The engine runs under the model's default FalconGEMM policy
(``falcon_config_for``: auto mode, backend "cuda", no plan cache) with
precombined weights and, on the card, one CUDA graph a bucket step. The
loop submits requests and calls ``step()``; each token's time is read in
the engine's ``on_token`` callback. The ramp runs the loop for the mix's
``ramp_s`` seconds, so the window opens on a loop in its steady state; the
window then runs until the first step that ends at or after its close.
"""
from __future__ import annotations

import time
from collections import Counter

from .record import ReqRec, StepRec
from .trace import span
from .traffic import Deck

__all__ = ["build_engine", "Loop"]


def build_engine(cfg, params, mix: dict, deck: Deck, device: str):
    """The engine of ``cfg`` on ``params`` at the mix's grid, warmed."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.buckets import BucketPolicy

    policy = BucketPolicy(prefill_seq=tuple(mix["prefill_seq_buckets"]),
                          prefill_batch=tuple(mix["prefill_batch_buckets"]),
                          decode_batch=tuple(mix["decode_batch_buckets"]))
    engine = ServeEngine(cfg, params=params, max_slots=mix["slots"],
                         max_prompt_len=deck.max_prompt, max_new_tokens=deck.max_output,
                         policy=policy, precombine=True, cuda_graphs=True, device=device)
    warm = engine.warm()
    return engine, warm


class Loop:
    """Closed-loop clients over one engine."""

    def __init__(self, engine, deck: Deck):
        self.engine, self.deck = engine, deck
        self.requests: list[ReqRec] = []
        self.live: dict[int, object] = {}          # client -> its Request in flight
        self.by_rid: dict[int, ReqRec] = {}
        self.steps: list[StepRec] = []
        self.sent = 0
        self._tokens: list = []         # (Request, time) emitted by the step running

    def _on_token(self, req, tok) -> None:
        self._tokens.append((req, time.perf_counter()))

    def _submit(self, client: int, first: bool) -> None:
        with span("portbench.submit"):
            tokens, out = self.deck.request(self.sent, client, first)
            req = self.engine.submit(tokens, max_new_tokens=out, on_token=self._on_token)
            rec = ReqRec(req.rid, len(tokens), out, req.submit_t)
            self.requests.append(rec)
            self.by_rid[req.rid] = rec
            self.live[client] = req
            self.sent += 1

    def start(self) -> None:
        for client in range(self.deck.mix["clients"]):
            self._submit(client, True)

    def step(self) -> StepRec:
        """One engine step, its record, then the clients whose requests
        finished send their next ones."""
        st = self.engine.stats
        before = (st.prefill_steps, st.prompt_tokens, st.prefill_padded_tokens,
                  st.decode_real_rows, st.decode_padded_tokens)
        self._tokens = []
        with span("portbench.step"):
            t0 = time.perf_counter()
            if not self.engine.step():
                raise RuntimeError("the engine went idle inside a closed loop")
            t1 = time.perf_counter()
        prefill = st.prefill_steps > before[0]
        rows = []
        for req, t in self._tokens:
            rec = self.by_rid[req.rid]
            rec.token_t.append(t)
            if len(req.generated) == 1:         # its first token: from the prefill
                rec.first_t = req.first_token_t
                rows.append((req.prompt_len, req.prompt_len))
            else:                               # the token it fed sits at kv - 1
                rows.append((1, req.prompt_len + len(req.generated) - 1))
            if req.done:
                rec.finish_t = req.finish_t
        if prefill:
            real, padded = st.prompt_tokens - before[1], st.prefill_padded_tokens - before[2]
            batch = self.engine.policy.prefill_batch_bucket(len(rows))
            seq = padded // batch
        else:
            real, padded = st.decode_real_rows - before[3], st.decode_padded_tokens - before[4]
            batch, seq = padded, 1
        rec = StepRec(len(self.steps), "prefill" if prefill else "decode", t0, t1,
                      batch, seq, real, len(self._tokens), rows)
        self.steps.append(rec)
        with span("portbench.clients"):
            for client in range(self.deck.mix["clients"]):
                if self.live[client].done:
                    self._submit(client, False)
        return rec

    def run_until(self, t_end: float) -> list:
        """Steps until one ends at or after ``t_end``; returns them."""
        first = len(self.steps)
        while not self.steps[first:] or self.steps[-1].t1 < t_end:
            self.step()
        return self.steps[first:]


def launch_state() -> Counter:
    """The port's launch counters (graph replays included)."""
    from repro_torch import kernels
    return kernels.launch_state()
