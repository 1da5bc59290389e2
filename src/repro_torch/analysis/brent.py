"""Pass 1 — exact Brent-equation verification of LCMA schemes.

A scheme ``<m,k,n,R,U,V,W>`` multiplies matrices iff the Brent equations

    sum_r U[r,i,l] * V[r,l',j] * W[r,i',j'] = d(i,i') d(j,j') d(l,l')

hold for every index tuple — ``m*k * k*n * m*n`` polynomial identities over
the integers. Because every coefficient is an integer (``LCMA.__post_init__``
guarantees int8), the identities are decidable *exactly*: the residual tensor
is computed in int64 (no overflow: ``|residual| <= R * 127**3``, far below
2**63 for any scheme this library can represent) and compared to zero. No
float tolerance is involved, so a verified scheme is certified, not "close".

This is the promotion gate for machine-generated schemes: ``discovery.py``
candidates and ``algorithms.register()`` inputs both route through
:func:`verify_or_raise` before they can reach the dispatcher.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lcma import LCMA, matmul_tensor
from .findings import ERROR, Finding

__all__ = ["brent_residual", "check_scheme", "check_library", "verify_or_raise"]

PASS = "brent"


def brent_residual(l: LCMA) -> np.ndarray:
    """Exact integer residual ``T(U,V,W) - T_<m,k,n>``; zero iff valid.

    Axes are ``(i, l, l', j, i', j')`` — the first pair indexes A's block,
    the second B's, the third C's.
    """
    U = l.U.astype(np.int64)
    V = l.V.astype(np.int64)
    W = l.W.astype(np.int64)
    T = np.einsum("ria,rbj,rcd->iabjcd", U, V, W)
    return T - matmul_tensor(l.m, l.k, l.n)


def check_scheme(l: LCMA) -> list[Finding]:
    """Verify one scheme; findings name the violated Brent equations."""
    res = brent_residual(l)
    bad = np.argwhere(res != 0)
    if bad.size == 0:
        return []
    i, a, b, j, c, d = bad[0]
    worst = int(np.max(np.abs(res)))
    return [Finding(
        PASS, ERROR, l.name,
        f"{l.key}: {len(bad)}/{res.size} Brent equations violated "
        f"(first at A[{i},{a}] B[{b},{j}] C[{c},{d}]: residual "
        f"{int(res[i, a, b, j, c, d])}, worst |residual| {worst}); "
        f"the scheme does not compute <{l.m},{l.k},{l.n}> matmul")]


def check_library(lib: dict[str, LCMA] | None = None) -> list[Finding]:
    """Verify every scheme in the library (or a given name->LCMA mapping).

    The built-in library includes the output of every composition operator
    (``tensor_product``, ``concat_m/k/n``, ``cyclic``, ``transpose_dual``),
    so a clean run certifies both the elementary schemes and the closure
    constructions actually shipped.
    """
    if lib is None:
        from repro_torch.core import algorithms
        lib = algorithms.library()
    findings: list[Finding] = []
    for name, l in sorted(lib.items()):
        findings.extend(check_scheme(l))
        if l.R >= l.m * l.k * l.n:
            findings.append(Finding(
                PASS, "warning", name,
                f"rank R={l.R} >= m*k*n={l.m * l.k * l.n}: no multiplication "
                f"saving (valid but never profitable)"))
    return findings


def verify_or_raise(l: LCMA, context: str = "") -> LCMA:
    """Exact verification as a gate: raises ``ValueError`` on any violation."""
    findings = check_scheme(l)
    if findings:
        where = f"{context}: " if context else ""
        raise ValueError(where + str(findings[0]))
    return l
