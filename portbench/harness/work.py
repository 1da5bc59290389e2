"""The work a step needs, counted from shapes, and the chip's peaks.

A product leaf (M real rows, K, N) counts ``2 * M * K * N * FLOOR`` operations
and its A, its raw B and its C in bytes, each once. FLOOR = 49/64 is the
lowest rank ratio in the port's scheme library (s444 and sw444: rank 49 of a
4 x 4 x 4 grid's 64 block products; ``repro_torch/core/algorithms.py``),
frozen here. The claim of the system is effective FLOP/s above the card's
peak: counted classically, an honest LCMA could read over 100% of the peak
and be refused as impossible; counted at the floor, every share stays at or
under 1 whichever path a later change takes. Rows are real rows, not the
bucket's padded ones, so padding shows as lost share.

Attention is counted at its real context: for a row with q new tokens ending
at context length kv, the query-key and probability-value products each
take ``2 * hd * sum over the q queries of their causal key counts`` per
head (also at the floor: the port plans them as products), and the bytes
are the cached keys and values read once, the new ones written once, q and
the output once.

A step's least time is max(operations / peak, bytes / bandwidth) of all its
work, with every weight read once; the peaks are NVIDIA's data sheet's for
the H100 SXM (dense bf16, HBM3), the same arithmetic as the port's kernel
timing (``chip_smoke.py``'s ``bound_ms``).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

__all__ = ["FLOOR", "PEAKS", "peaks_for", "Model", "Leaf", "step_leaves", "least_time"]

FLOOR = Fraction(49, 64)

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAKS = {
    "H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
                       "tf32": 495e12, "fp8": 1979e12, "int8": 1979e12,
                       "bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict | None:
    """The peak table of the card named ``device_name``; None where unknown."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


@dataclasses.dataclass(frozen=True)
class Model:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    dtype_bytes: int = 2

    @classmethod
    def from_config(cls, spec: dict) -> "Model":
        d, heads = spec["hidden_size"], spec["num_attention_heads"]
        nbytes = {"bfloat16": 2, "float16": 2, "float32": 4}[spec["torch_dtype"]]
        return cls(spec["num_hidden_layers"], d, heads, spec["num_key_value_heads"],
                   spec.get("head_dim") or d // heads, spec["intermediate_size"],
                   spec["vocab_size"], nbytes)

    def projections(self) -> dict:
        """(K, N) of each projection of one layer."""
        d, qd, kvd = self.d, self.heads * self.head_dim, self.kv_heads * self.head_dim
        return {"w_q": (d, qd), "w_k": (d, kvd), "w_v": (d, kvd), "w_o": (qd, d),
                "mlp_gate": (d, self.ff), "mlp_up": (d, self.ff), "mlp_down": (self.ff, d)}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One product of a step (summed over the layers where ``count`` > 1)."""
    name: str
    flops: float            # at the floor
    nbytes: float

    def least_s(self, peaks: dict, dtype: str = "bfloat16") -> float:
        return max(self.flops / peaks[dtype], self.nbytes / peaks["bytes_per_s"])


def _causal_keys(q: int, kv: int) -> int:
    """Keys the q queries ending at context kv see, summed: kv-q+1 .. kv."""
    return q * kv - q * (q - 1) // 2


def step_leaves(model: Model, rows: list) -> list:
    """The product leaves of a step whose real rows are ``rows`` [(q, kv)]:
    each projection of each layer over all rows, the LM head over one
    position a row, and each layer's two attention products."""
    m, b, L = model, model.dtype_bytes, model.layers
    M = sum(q for q, _ in rows)
    floor = float(FLOOR)
    leaves = []
    for name, (K, N) in m.projections().items():
        leaves += [Leaf(name, 2 * M * K * N * floor, (M * K + K * N + M * N) * b)] * L
    R = len(rows)
    leaves.append(Leaf("lm_head", 2 * R * m.d * m.vocab * floor,
                       (R * m.d + m.d * m.vocab + R * m.vocab) * b))
    keys = sum(_causal_keys(q, kv) for q, kv in rows)
    kv_read = sum(kv for _, kv in rows) * m.kv_heads * m.head_dim * b
    qo = M * m.heads * m.head_dim * b
    for name in ("attn_qk", "attn_pv"):
        leaves += [Leaf(name, 2 * m.heads * m.head_dim * keys * floor, kv_read + qo)] * L
    return leaves


def least_time(model: Model, rows: list, peaks: dict) -> float:
    """A step's least time on the card: all its operations at the peak or
    all its bytes at the bandwidth, whichever is longer. Bytes: every
    weight once, each product's activations once, the keys and values it
    reads once and the new ones it writes once."""
    leaves = step_leaves(model, rows)
    flops = sum(leaf.flops for leaf in leaves)
    nbytes = sum(leaf.nbytes for leaf in leaves)
    new_kv = sum(q for q, _ in rows) * 2 * model.kv_heads * model.head_dim \
        * model.dtype_bytes * model.layers
    return max(flops / peaks["bfloat16"], (nbytes + new_kv) / peaks["bytes_per_s"])
