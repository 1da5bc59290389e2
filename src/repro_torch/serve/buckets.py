"""Shape buckets: the fixed grid of step shapes the engine ever launches.

Serving traffic presents ragged, shifting M — prompt lengths and batch
occupancy change every step. Rather than tracing (and re-planning) a fresh
shape per step, every micro-batch is padded up to a bucket from a small
power-of-two grid, so each step runs a shape whose FalconGEMM plan is already
decided, precombined and, on the card, captured as a CUDA graph. The
policy fixes:

* **prefill buckets** — (batch, padded sequence) pairs; M = batch x seq,
* **decode buckets**  — padded batch sizes; M = batch (one token per slot).

Padding is pure waste, so buckets grow geometrically: waste is bounded at
<50% of the step (amortized far less) while the number of distinct compiled
shapes stays logarithmic in the range served.
"""
from __future__ import annotations

import dataclasses

__all__ = ["next_pow2", "BucketPolicy"]


def next_pow2(n: int) -> int:
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def _pow2_range(lo: int, hi: int) -> tuple[int, ...]:
    out, v = [], next_pow2(max(lo, 1))
    while v < hi:
        out.append(v)
        v *= 2
    out.append(next_pow2(hi))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The step-shape grid for one engine instance."""

    prefill_seq: tuple[int, ...]        # padded prompt lengths (pow2, sorted)
    prefill_batch: tuple[int, ...]      # prefill micro-batch sizes (pow2, sorted)
    decode_batch: tuple[int, ...]       # decode micro-batch sizes (pow2, sorted)

    @classmethod
    def build(cls, max_prompt_len: int, max_slots: int,
              min_seq: int = 8, max_prefill_batch: int | None = None
              ) -> "BucketPolicy":
        mpb = min(max_prefill_batch or max_slots, max_slots)
        return cls(
            prefill_seq=_pow2_range(min_seq, max_prompt_len),
            prefill_batch=_pow2_range(1, mpb),
            decode_batch=_pow2_range(1, max_slots),
        )

    def __post_init__(self):
        for name in ("prefill_seq", "prefill_batch", "decode_batch"):
            vals = getattr(self, name)
            if not vals or list(vals) != sorted(set(vals)):
                raise ValueError(f"{name} must be non-empty, sorted, unique: {vals}")

    @staticmethod
    def _fit(n: int, grid: tuple[int, ...], what: str) -> int:
        for b in grid:
            if n <= b:
                return b
        raise ValueError(f"{what}={n} exceeds the largest bucket {grid[-1]}")

    def seq_bucket(self, prompt_len: int) -> int:
        """Smallest prefill sequence bucket holding ``prompt_len`` tokens."""
        return self._fit(prompt_len, self.prefill_seq, "prompt_len")

    def prefill_batch_bucket(self, n_requests: int) -> int:
        return self._fit(n_requests, self.prefill_batch, "n_requests")

    def decode_batch_bucket(self, n_active: int) -> int:
        return self._fit(n_active, self.decode_batch, "n_active")

    # -- enumeration (warmup) ----------------------------------------------

    def prefill_shapes(self) -> list[tuple[int, int]]:
        """Every (batch, seq) prefill step shape this policy can launch."""
        return [(b, s) for b in self.prefill_batch for s in self.prefill_seq]

    def bucket_ms(self) -> list[int]:
        """Every activation-row count M a step can present to the Decision
        Module — the grid ``core.engine.warm_buckets`` pre-plans."""
        ms = {b * s for (b, s) in self.prefill_shapes()}
        ms.update(self.decode_batch)
        return sorted(ms)
