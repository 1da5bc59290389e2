"""Deterministic, checkpointable synthetic LM data.

Tokens are a pure function of (seed, step, position) via a counter-based
hash (splitmix64 in numpy, the reference's exactly), so any worker can
regenerate any batch: restarts need no data state beyond the integer
``step``, and the port's batches are bit-equal to the reference's. A batch
is placed on the ``device`` the pipeline was made for; on a ``mesh``
(``batch_spec`` the axes its rows split over, as the reference's
``PartitionSpec``) each rank gets its rows of the same global batch, so
the topology never changes the data.

The stream is Zipfian with a Markov backbone, so the LM loss actually
decreases in short runs (uniform noise would pin it at log V).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticLMData"]


def _hash_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64 — vectorized counter-based PRNG."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_codebooks: int = 0       # musicgen-style parallel streams
    zipf_alpha: float = 1.1


class SyntheticLMData:
    """Stateless per step: ``batch(step)`` is pure and deterministic."""

    def __init__(self, cfg: DataConfig, device="cuda", mesh=None, batch_spec=("data",)):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.batch_spec = tuple(batch_spec or ())
        if mesh is not None and cfg.global_batch % mesh.size(self.batch_spec):
            raise ValueError(f"a global batch of {cfg.global_batch} rows does not split over "
                             f"the {mesh.size(self.batch_spec)} ranks of {self.batch_spec}")
        # Zipf-ish stationary distribution over the vocabulary
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._cdf = np.cumsum(p / p.sum())

    def _tokens(self, step: int) -> np.ndarray:
        c = self.cfg
        shape = (c.global_batch, c.seq_len + 1)
        if c.num_codebooks:
            shape = shape + (c.num_codebooks,)
        n = int(np.prod(shape))
        ctr = (np.uint64(c.seed) << np.uint64(40)) + (np.uint64(step) << np.uint64(20))
        raw = _hash_u64(np.arange(n, dtype=np.uint64) + ctr)
        u = (raw >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        base = np.searchsorted(self._cdf, u).astype(np.int64)
        # Markov backbone: token_t depends on token_{t-1} for learnability
        flat = base.reshape(shape)
        if not c.num_codebooks:
            prev = np.roll(flat, 1, axis=1)
            flat = (flat + 7 * prev) % c.vocab_size
        return np.clip(flat, 0, c.vocab_size - 1).astype(np.int32)

    def batch(self, step: int) -> dict:
        """{'tokens', 'labels'}: (B, S[, CB]) int64 tensors on the device,
        the labels the tokens shifted by one position. On a mesh B is this
        rank's rows: the global batch split in rank order over
        ``batch_spec``."""
        toks = self._tokens(step)
        if self.mesh is not None and self.batch_spec:
            n = self.mesh.size(self.batch_spec)
            rows = toks.shape[0] // n
            lo = self.mesh.local_rank(self.batch_spec) * rows
            toks = toks[lo:lo + rows]
        toks = torch.from_numpy(toks).to(self.device, torch.int64)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
