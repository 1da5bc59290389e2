"""Pass 2 — numerical-stability and integer-overflow analysis.

Two static questions are answered per scheme, before any kernel launches:

**Floating-point error growth (Higham-style).** A one-level bilinear scheme
amplifies rounding error by a factor determined entirely by its coefficient
tensors. With

  * ``alpha_u = max_r sum_{i,l} |U[r,i,l]|``  (worst Combine-A magnification),
  * ``alpha_v = max_r sum_{l,j} |V[r,l,j]|``  (worst Combine-B magnification),
  * ``alpha_w = max_{i,j} sum_r |W[r,i,j]|``  (worst Combine-H magnification),
  * ``q_u/q_v/q_w`` the corresponding worst-case term counts (additions),

the computed block satisfies (Higham, *Accuracy and Stability of Numerical
Algorithms*, §23.2, specialized to one level)

    |C_hat - C| <= growth * terms * u * ||A||_max ||B||_max * K + O(u^2),

with ``growth = alpha_u * alpha_v * alpha_w`` and ``terms = q_u + q_v + q_w
+ 2``. The *relative* per-scheme figure ``error_bound(dtype) = growth *
terms * u(dtype)`` is what the Decision Module compares against a call
site's accuracy budget: standard GEMM has growth 1 per output term, Strassen
~16, and |c|>1 listings (AlphaTensor standard-arithmetic, Smirnov) grow
quadratically in the coefficient magnitude — exactly the schemes a bf16
serving path must be able to reject statically.

**int8 accumulator overflow.** The quantized pipeline
(the int8 slice of the kernels) accumulates ``int8 x int8 -> int32``
products over a reduction block of ``depth`` elements. The worst-case partial
sum is ``depth * 127 * 127``; the accumulator is safe iff that fits the
signed accumulator width. :func:`max_safe_accum_depth` is the exact bound the
kernel-plan lint enforces and ``fused_gemm_combine_h_quant`` guards at call
time.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lcma import LCMA
from .findings import ERROR, INFO, WARNING, Finding

__all__ = ["SchemeStability", "analyze", "check_scheme_stability",
           "check_library_stability", "INT8_MAX", "int8_accum_bound",
           "max_safe_accum_depth", "check_quant_accumulator", "dtype_eps"]

PASS = "stability"

# Unit roundoff per dtype. int8 is the quantization step of the symmetric
# 127-level block-scaled scheme (relative, half an LSB at full scale).
_DTYPE_EPS = {
    "float64": 2.0 ** -53,
    "float32": 2.0 ** -24,
    "bfloat16": 2.0 ** -8,
    "float16": 2.0 ** -11,
    "int8": 1.0 / (2 * 127),
}


def dtype_eps(dtype: str) -> float:
    try:
        return _DTYPE_EPS[str(dtype)]
    except KeyError:
        raise ValueError(f"stability model: unknown dtype {dtype!r}; known: "
                         f"{sorted(_DTYPE_EPS)}") from None


@dataclasses.dataclass(frozen=True)
class SchemeStability:
    """Static error-growth profile of one LCMA scheme."""

    name: str
    alpha_u: int          # max_r ||U[r]||_1
    alpha_v: int          # max_r ||V[r]||_1
    alpha_w: int          # max_{i,j} sum_r |W[r,i,j]|
    q_u: int              # max_r nnz(U[r])  (terms in the longest Combine-A)
    q_v: int
    q_w: int              # max_{i,j} nnz_r(W[:,i,j])
    max_abs_coeff: int

    @property
    def growth(self) -> int:
        """Magnitude amplification factor alpha_u * alpha_v * alpha_w."""
        return self.alpha_u * self.alpha_v * self.alpha_w

    @property
    def terms(self) -> int:
        """Length of the worst rounding-error accumulation chain."""
        return self.q_u + self.q_v + self.q_w + 2

    def error_bound(self, dtype: str = "bfloat16") -> float:
        """Relative first-order error bound ``growth * terms * u(dtype)``."""
        return float(self.growth) * float(self.terms) * dtype_eps(dtype)

    def within_budget(self, budget: float, dtype: str = "bfloat16") -> bool:
        return self.error_bound(dtype) <= budget


def analyze(l: LCMA) -> SchemeStability:
    """Compute the stability profile from the coefficient tensors alone."""
    aU = np.abs(l.U.astype(np.int64))
    aV = np.abs(l.V.astype(np.int64))
    aW = np.abs(l.W.astype(np.int64))
    return SchemeStability(
        name=l.name,
        alpha_u=int(aU.sum(axis=(1, 2)).max()),
        alpha_v=int(aV.sum(axis=(1, 2)).max()),
        alpha_w=int(aW.sum(axis=0).max()),
        q_u=int((aU > 0).sum(axis=(1, 2)).max()),
        q_v=int((aV > 0).sum(axis=(1, 2)).max()),
        q_w=int((aW > 0).sum(axis=0).max()),
        max_abs_coeff=int(max(aU.max(), aV.max(), aW.max())),
    )


def check_scheme_stability(l: LCMA, *, budget: float | None = None,
                           dtype: str = "bfloat16") -> list[Finding]:
    """Stability findings for one scheme.

    Always reports the bound as INFO; flags |c|>1 schemes as WARNING (their
    error bound exceeds every same-grid ternary scheme's — the class the
    PR 4 combine-magnitude bug hid); flags a budget violation as ERROR when
    the caller supplies an accuracy budget.
    """
    s = l.stability
    findings = [Finding(
        PASS, INFO, l.name,
        f"growth={s.growth} terms={s.terms} "
        f"error_bound({dtype})={s.error_bound(dtype):.3e}")]
    if s.max_abs_coeff > 1:
        findings.append(Finding(
            PASS, WARNING, l.name,
            f"coefficient magnitude {s.max_abs_coeff} > 1: error bound "
            f"{s.error_bound(dtype):.3e} ({dtype}) vs {s.growth}x magnitude "
            f"growth; exclude from low-precision serving unless budgeted"))
    if budget is not None and not s.within_budget(budget, dtype):
        findings.append(Finding(
            PASS, ERROR, l.name,
            f"error bound {s.error_bound(dtype):.3e} exceeds the accuracy "
            f"budget {budget:.3e} for {dtype}"))
    return findings


def check_library_stability(lib: dict[str, LCMA] | None = None, *,
                            budget: float | None = None,
                            dtype: str = "bfloat16") -> list[Finding]:
    if lib is None:
        from repro_torch.core import algorithms
        lib = algorithms.library()
    findings: list[Finding] = []
    for _, l in sorted(lib.items()):
        findings.extend(check_scheme_stability(l, budget=budget, dtype=dtype))
    return findings


# ---------------------------------------------------------------------------
# int8 accumulator overflow bounds (kernels/quant_combine.py)
# ---------------------------------------------------------------------------

INT8_MAX = 127


def int8_accum_bound(depth: int) -> int:
    """Worst-case |partial sum| of ``depth`` int8 x int8 products."""
    return int(depth) * INT8_MAX * INT8_MAX


def max_safe_accum_depth(acc_bits: int = 32) -> int:
    """Largest reduction-block depth that cannot overflow the accumulator.

    ``acc_bits`` is the signed accumulator width (32 for an int32 path).
    Exact: ``floor((2**(acc_bits-1) - 1) / 127**2)`` — 133144 for int32, so
    every practical K-block (<= a few thousand) is safe by a wide margin,
    while an int16 accumulator (acc_bits=16) is unsafe beyond depth 2.
    """
    return (2 ** (int(acc_bits) - 1) - 1) // (INT8_MAX * INT8_MAX)


def check_quant_accumulator(depth: int, acc_bits: int = 32,
                            subject: str = "quant-accumulator") -> list[Finding]:
    """Flag a quantized-GEMM reduction block that can overflow its accumulator."""
    depth = int(depth)
    if depth < 1:
        return [Finding(PASS, ERROR, subject,
                        f"reduction depth must be >= 1, got {depth}")]
    safe = max_safe_accum_depth(acc_bits)
    if depth > safe:
        return [Finding(
            PASS, ERROR, subject,
            f"int8 reduction depth {depth} can overflow the int{acc_bits} "
            f"accumulator: worst-case |sum| = {int8_accum_bound(depth)} > "
            f"{2 ** (acc_bits - 1) - 1} (max safe depth {safe})")]
    return [Finding(
        PASS, INFO, subject,
        f"int8 depth {depth} safe for int{acc_bits}: worst-case |sum| "
        f"{int8_accum_bound(depth)} <= {2 ** (acc_bits - 1) - 1}")]
