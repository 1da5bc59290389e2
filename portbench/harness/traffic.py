"""Closed-loop traffic from a mix file and a seed.

A mix file gives the number of clients, the prompt and output length
distributions and the size of the deck. The deck is a fixed list of
(prompt, output) length pairs at stratified quantiles of the two
distributions (the outputs in a fixed low-discrepancy order against the
prompts), served in a fixed shuffled order: the same sizes in the same
order for every seed. The seed only draws the token ids, uniform over the
real vocabulary. In a closed loop that batches prompts, which prompts share
a step follows from the order, so an order drawn from the seed would change
the work from seed to seed.

Request ``j`` of the run is deck entry ``order[j % deck]`` (a fixed order
for each pass over the deck) with tokens from a generator seeded by
``(seed, j)``. In the closed loop each client sends its next request as soon
as its previous one finishes, so request ``j`` goes to whichever client asks
``j``-th. With ``stagger_first`` each client's first request is cut to a
share (i + 0.5) / clients of its output, so finishes are spread from the
start as in a loop that has run for a while.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Deck", "lengths", "check_mix"]

GOLDEN = (math.sqrt(5) - 1) / 2
ORDER_KEY = 20241                   # the deck's order, the same for every seed


def lengths(dist: dict, n: int, order=None) -> np.ndarray:
    """``n`` stratified lengths of ``dist`` ({"dist": "fixed", "value"} or
    {"dist": "uniform" | "log_uniform", "min", "max"}), at the quantiles
    (i + 0.5) / n taken in ``order`` (default ascending)."""
    u = (np.arange(n) + 0.5) / n if order is None else order
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    lo, hi = float(dist["min"]), float(dist["max"])
    if kind == "uniform":
        x = lo + (hi - lo) * u
    elif kind == "log_uniform":
        x = lo * (hi / lo) ** u
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def check_mix(mix: dict) -> None:
    """Refuse a mix the engine's grid cannot serve."""
    if mix.get("loop") != "closed":
        raise ValueError(f"traffic {mix['name']}: only the closed loop is implemented")
    top = max(mix["prefill_seq_buckets"])
    if mix["prompt_tokens"].get("max", mix["prompt_tokens"].get("value")) > top:
        raise ValueError(f"traffic {mix['name']}: prompts exceed the largest bucket {top}")
    if mix["slots"] > max(mix["decode_batch_buckets"]):
        raise ValueError(f"traffic {mix['name']}: more slots than the largest decode bucket")


class Deck:
    """The run's requests, numbered from 0."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        check_mix(mix)
        n = int(mix["deck"])
        self.mix, self.vocab, self.seed, self.n = mix, vocab, int(seed) % 2**64, n
        self.prompt = lengths(mix["prompt_tokens"], n)
        # outputs in a fixed low-discrepancy order against the prompts
        self.output = lengths(mix["output_tokens"], n, ((np.arange(n) * GOLDEN) % 1.0))
        self._orders: dict[int, np.ndarray] = {}

    @property
    def max_prompt(self) -> int:
        return int(self.prompt.max())

    @property
    def max_output(self) -> int:
        return int(self.output.max())

    def entry(self, j: int) -> int:
        lap = j // self.n
        if lap not in self._orders:
            self._orders[lap] = np.random.default_rng([ORDER_KEY, 1, lap]).permutation(self.n)
        return int(self._orders[lap][j % self.n])

    def request(self, j: int, client: int, first: bool) -> tuple[np.ndarray, int]:
        """(prompt token ids, output tokens) of request ``j``, sent by
        ``client`` (its first request where ``first``)."""
        e = self.entry(j)
        tokens = np.random.default_rng([self.seed, 2, j]).integers(
            0, self.vocab, size=int(self.prompt[e]), dtype=np.int64)
        out = int(self.output[e])
        if first and self.mix.get("stagger_first"):
            out = max(1, math.ceil(out * (client + 0.5) / self.mix["clients"]))
        return tokens, out
