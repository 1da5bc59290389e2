"""Whether what the window served is correct: served tokens against the
plain reference.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests that finished in the window, the
longest of them always among it, is run through the reference once over
each prompt with its served tokens. Each served token's logit in the
reference is compared with the reference's best logit at its position, over
the real vocabulary; the widest gap over the sample is the number compared
(``logit_gap``). Greedy decoding serves the top token, so a sound program
reads a gap only where two logits lie within its rounding of each other.

The first served token comes from the prefill's logits (through whatever
path the Decision Module planned at that step's rows), every later one from
a decode step reading the cache the prefill and the earlier decodes wrote.

``judge`` turns the gaps into the compared numbers, each beside its limit,
and ``correct``. The control goes through the same ``judge``: the reference
in float8 put in the program's place, its tokens (the one it puts first at
each of the same positions) judged as the program's are. The benchmark's
runs do not run it; ``portbench/control.py`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["sample", "served", "gaps", "judge", "control_tokens"]


def sample(requests: list, t0: float, t1: float, n: int, seed: int) -> list:
    """The requests (engine Requests) that finished in [t0, t1]: the one
    with the most tokens, and ``n - 1`` more drawn from the seed."""
    done = [r for r in requests if r.done and r.finish_t is not None and t0 <= r.finish_t <= t1]
    if not done:
        return []
    done.sort(key=lambda r: r.rid)
    longest = max(done, key=lambda r: (r.prompt_len + len(r.generated), -r.rid))
    rest = [r for r in done if r is not longest]
    k = min(n - 1, len(rest))
    picked = np.random.default_rng([int(seed) % 2**64, 3]).choice(len(rest), size=k, replace=False)
    return [longest] + [rest[i] for i in sorted(picked)]


def served(reqs: list) -> tuple[list, list, list]:
    """(sequences, scored positions, served tokens) of each request, as
    plain lists that hold nothing of the engine: the prompt and every
    served token but the last, whose logits at positions prompt_len - 1 ..
    end gave the served tokens."""
    seqs, pos, toks = [], [], []
    for r in reqs:
        gen = [int(t) for t in r.generated]
        seqs.append([int(t) for t in r.prompt] + gen[:-1])
        pos.append(list(range(r.prompt_len - 1, r.prompt_len - 1 + len(gen))))
        toks.append(gen)
    return seqs, pos, toks


def gaps(ref_logits: list, toks: list) -> np.ndarray:
    """Each token's gap below the best logit of its row, all requests."""
    out = []
    for lg, t in zip(ref_logits, toks):
        t = torch.as_tensor(t, device=lg.device).long()
        out.append((lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def judge(g: np.ndarray, check: dict) -> tuple[dict, bool]:
    """(each compared number with its limit, correct) of the gaps ``g`` of
    the served tokens, against the cell's check (``cells/<cell>.json``): the
    widest gap within ``limits.logit_gap`` over at least
    ``min_served_tokens`` tokens."""
    n = int(len(g))
    checked = {"logit_gap": {"value": float(g.max()) if n else math.inf,
                             "limit": check["limits"]["logit_gap"]},
               "served_tokens": {"value": n, "limit": check["min_served_tokens"]}}
    correct = (n >= check["min_served_tokens"]
               and checked["logit_gap"]["value"] <= checked["logit_gap"]["limit"])
    return checked, bool(correct)


def control_tokens(ctl_logits: list) -> list:
    """The token the control puts first at each position."""
    return [lg.argmax(dim=-1).cpu().numpy() for lg in ctl_logits]
