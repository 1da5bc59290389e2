"""Deployment Module: automated code generation for LCMAs (paper §III-A).

A meta-programming engine emits PyTorch source for a given scheme
``L = <m,k,n,R,U,V,W>``. The coefficient tensors are baked into the emitted
source as literal ``+``/``-`` terms, so:

  * zero coefficients are pruned at generation time (constant folding),
  * no runtime memory traffic is spent on coefficients (they live in the
    generated program, not in a device table),
  * every combine is a fixed sequence of elementwise tensor ops.

Two workflow variants are generated:

  * ``gemm_backend="batched"`` — Algorithm 2 (Group-Parallel): grouped
    combines, ONE batched GEMM over the rank dimension, Combine-H applied to
    the high-precision accumulator before any downcast (paper §IV-F).
  * ``gemm_backend="loop"`` — Algorithm 1's H_r-parallel baseline: R
    fragmented GEMMs; with ``downcast_h`` H is materialized in the input
    dtype (the AlphaTensor-style precision loss).

Either way H is a tensor in memory between the product and Combine H, so
the Decision Module prices the generated ``"torch"`` backend unfused
(``decision.estimate(fused=False)``). The reference's ``fused`` option only
labels its generated docstring; the port has none.

The batched product keeps H in ``accum_dtype``: a bf16 product on a CUDA
device is one ``torch.bmm(..., out_dtype=torch.float32)`` (cuBLAS's f32
accumulator written out as is); the CPU has no such kernel and multiplies
the operands upcast to f32, which is the same arithmetic.

The emitted source is kept on the returned object (``.source``): it is the
deployment artifact, inspectable and diffable. The ``"cuda"`` backend runs
the same coefficients through the hand-written kernels (``repro_torch.kernels``).
Generated functions are cached on the scheme's ``fingerprint`` (its
coefficients) and the options, so a scheme re-registered under the same name
gets fresh code.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .lcma import LCMA

__all__ = ["CodegenOptions", "GeneratedLCMA", "generate", "product"]


@dataclasses.dataclass(frozen=True)
class CodegenOptions:
    accum_dtype: str = "float32"     # GEMM accumulation / H precision
    downcast_h: bool = False         # materialize H in the input dtype
    precombined_b: bool = False      # offline Combine B for static weights
    gemm_backend: str = "batched"    # "batched" (Alg. 2) | "loop" (Alg. 1 fragmentation)

    def cache_key(self, fingerprint: str) -> tuple:
        return (fingerprint, self.accum_dtype, self.downcast_h,
                self.precombined_b, self.gemm_backend)


@dataclasses.dataclass(frozen=True)
class GeneratedLCMA:
    """A deployed LCMA: generated source + compiled callables."""

    lcma: LCMA
    options: CodegenOptions
    source: str
    fn: Callable            # (A, B) -> C           [or (A, Bt) if precombined_b]
    combine_a: Callable     # (A,)  -> At (..., R, M/m, K/k)
    combine_b: Callable     # (B,)  -> Bt (..., R, K/k, N/n)
    stages: dict            # name -> callable, for the step-wise benchmark


def product(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) with the result in ``out_dtype``.

    A narrower input on a CUDA device keeps cuBLAS's f32 accumulator:
    ``torch.mm``/``torch.bmm`` with ``out_dtype``. On the CPU, which has no
    such kernel, the operands are upcast (exact) and multiplied in f32.
    """
    if a.dtype == out_dtype:
        return torch.matmul(a, b)
    mm = torch.bmm if a.ndim == 3 else torch.mm
    if a.device.type == "cuda":
        return mm(a, b, out_dtype=out_dtype)
    return mm(a.to(out_dtype), b.to(out_dtype))


# --------------------------------------------------------------------------
# Source emission helpers
# --------------------------------------------------------------------------

def _lin_comb(terms: list[tuple[int, str]], zero: str) -> str:
    """Emit ``x - 2 * y + z`` from [(coeff, name), ...] for integer coeffs.

    Magnitudes other than 1 (AlphaTensor standard-arithmetic listings,
    Smirnov-family schemes) are emitted as literal scalings; ``zero`` is
    the expression for an empty sum.
    """
    if not terms:
        return zero
    out = []
    for idx, (c, name) in enumerate(terms):
        term = name if abs(c) == 1 else f"{abs(c)} * {name}"
        if idx == 0:
            out.append(term if c > 0 else f"-{term}")
        else:
            out.append(f"+ {term}" if c > 0 else f"- {term}")
    return " ".join(out)


def _emit_combine(coeff: np.ndarray, part: str, out: str, d1: int, d2: int) -> list[str]:
    """Emit the group-combine of ``part_{i}_{l}`` into ``out_r`` for all r."""
    lines = []
    for r in range(coeff.shape[0]):
        terms = [(int(coeff[r, i, l]), f"{part}_{i}_{l}")
                 for i in range(d1) for l in range(d2) if coeff[r, i, l] != 0]
        lines.append(f"{out}_{r} = {_lin_comb(terms, f'torch.zeros_like({part}_0_0)')}")
    return lines


def _emit_slices(var: str, part: str, d1: int, d2: int, s1: str, s2: str) -> list[str]:
    """Block (i, l) of the trailing two dims of ``var`` (views, no copy)."""
    return [f"{part}_{i}_{l} = {var}[..., {i} * {s1}:({i} + 1) * {s1}, "
            f"{l} * {s2}:({l} + 1) * {s2}]"
            for i in range(d1) for l in range(d2)]


def _emit_source(l: LCMA, o: CodegenOptions) -> str:
    m, k, n, R = l.m, l.k, l.n, l.R
    U, V, W = l.U, l.V, l.W
    body: list[str] = []
    e = body.append

    e("def combine_a(A):")
    e("    M, K = A.shape[-2:]")
    e(f"    Ms, Ks = M // {m}, K // {k}")
    for ln in _emit_slices("A", "a", m, k, "Ms", "Ks"):
        e("    " + ln)
    e("    # Group Combine A (Eq. 3) -- coefficients are literal terms")
    for ln in _emit_combine(U, "a", "at", m, k):
        e("    " + ln)
    e("    return torch.stack([" + ", ".join(f"at_{r}" for r in range(R)) + "], dim=-3)")
    e("")

    e("def combine_b(B):")
    e("    K, N = B.shape[-2:]")
    e(f"    Ks, Ns = K // {k}, N // {n}")
    for ln in _emit_slices("B", "b", k, n, "Ks", "Ns"):
        e("    " + ln)
    e("    # Group Combine B (Eq. 4)")
    for ln in _emit_combine(V, "b", "bt", k, n):
        e("    " + ln)
    e("    return torch.stack([" + ", ".join(f"bt_{r}" for r in range(R)) + "], dim=-3)")
    e("")

    # --- GEMM stage ---
    e("def gemm_stage(At, Bt):")
    if o.gemm_backend == "batched":
        e("    # single batched GEMM over the rank dimension (Eq. 5)")
        e(f"    H = product(At, Bt, torch.{o.accum_dtype})")
    else:
        e("    # H_r-parallel baseline: R fragmented GEMMs (paper §II-B drawback 2)")
        e("    hs = []")
        e(f"    for r in range({R}):")
        e(f"        hs.append(product(At[r], Bt[r], torch.{o.accum_dtype}))")
        e("    H = torch.stack(hs)")
    if o.downcast_h:
        e("    H = H.to(At.dtype)  # AlphaTensor-style downcast before materialization")
    e("    return H")
    e("")

    e("def combine_h(H, out_dtype):")
    e("    # Group Combine H (Eq. 6) from the accumulator, one cast per block")
    rows = []
    for i in range(m):
        cols = []
        for j in range(n):
            terms = [(int(W[r, i, j]), f"H[..., {r}, :, :]") for r in range(R)
                     if W[r, i, j] != 0]
            e(f"    c_{i}_{j} = ({_lin_comb(terms, 'torch.zeros_like(H[..., 0, :, :])')})"
              f".to(out_dtype)")
            cols.append(f"c_{i}_{j}")
        rows.append("torch.cat([" + ", ".join(cols) + "], dim=-1)")
    e("    return torch.cat([" + ", ".join(rows) + "], dim=-2)")
    e("")

    args = "A, Bt" if o.precombined_b else "A, B"
    e(f"def lcma_matmul({args}):")
    e('    """%s %s | gemm_backend=%s precombined_b=%s"""'
      % (l.name, l.key, o.gemm_backend, o.precombined_b))
    e("    out_dtype = A.dtype")
    e("    At = combine_a(A)")
    if not o.precombined_b:
        e("    Bt = combine_b(B)")
    e("    H = gemm_stage(At, Bt)")
    e("    return combine_h(H, out_dtype)")
    return "\n".join(body) + "\n"


# --------------------------------------------------------------------------
# Compilation
# --------------------------------------------------------------------------

_CACHE: dict[tuple, GeneratedLCMA] = {}


def generate(l: LCMA, options: CodegenOptions | None = None) -> GeneratedLCMA:
    """Generate + compile the LCMA implementation for scheme ``l``."""
    o = options or CodegenOptions()
    if o.gemm_backend not in ("batched", "loop"):
        raise ValueError(f"codegen: gemm_backend {o.gemm_backend!r} is not "
                         f"'batched' or 'loop'")
    key = o.cache_key(l.fingerprint)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    src = _emit_source(l, o)
    ns: dict = {"torch": torch, "product": product}
    exec(compile(src, f"<lcma:{l.name}>", "exec"), ns)  # noqa: S102 - trusted, self-emitted
    gen = GeneratedLCMA(
        lcma=l,
        options=o,
        source=src,
        fn=ns["lcma_matmul"],
        combine_a=ns["combine_a"],
        combine_b=ns["combine_b"],
        stages={
            "combine_a": ns["combine_a"],
            "combine_b": ns["combine_b"],
            "gemm": ns["gemm_stage"],
            "combine_h": ns["combine_h"],
        },
    )
    return _CACHE.setdefault(key, gen)
