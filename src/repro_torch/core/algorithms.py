"""LCMA scheme library: classical algorithms + validated constructions.

The paper draws its candidate set from AlphaTensor's published coefficients;
those exact tensors are not available offline, so this library populates
``S_LCMA`` with classical schemes (Strassen, Strassen-Winograd, Laderman) and
*constructed* schemes obtained by closure operations that provably preserve
correctness:

  * ``tensor_product``  <m1,k1,n1>;R1 x <m2,k2,n2>;R2 -> <m1m2,k1k2,n1n2>;R1R2
  * ``concat_m/k/n``    block-concatenation along one grid dimension
  * ``cyclic`` / ``transpose_dual``  symmetries of the matmul tensor

Every scheme — hand-written or constructed — is machine-verified against the
matmul tensor identity at library-build time (``lcma.validate``); an invalid
scheme is a hard error. Ranks match published optima where known (e.g.
<2,2,3>;11 equals the Hopcroft-Kerr rank).
"""
from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np

from .lcma import LCMA, validate

__all__ = [
    "standard", "strassen", "strassen_winograd", "laderman",
    "tensor_product", "concat_m", "concat_k", "concat_n",
    "cyclic", "transpose_dual", "library", "get", "candidates", "register",
    "unregister",
]


# --------------------------------------------------------------------------
# Elementary schemes
# --------------------------------------------------------------------------

def standard(m: int, k: int, n: int) -> LCMA:
    """The trivial rank-mkn algorithm (used as a composition building block)."""
    R = m * k * n
    U = np.zeros((R, m, k), np.int8)
    V = np.zeros((R, k, n), np.int8)
    W = np.zeros((R, m, n), np.int8)
    r = 0
    for i in range(m):
        for l in range(k):
            for j in range(n):
                U[r, i, l] = 1
                V[r, l, j] = 1
                W[r, i, j] = 1
                r += 1
    return LCMA(f"standard-{m}{k}{n}", m, k, n, R, U, V, W)


def _from_terms(name, m, k, n, terms, cexprs) -> LCMA:
    """Build an LCMA from symbolic product terms.

    ``terms``: list of (a_lin, b_lin) where a_lin maps (i,l)->coeff and
    b_lin maps (l,j)->coeff.   ``cexprs``: maps (i,j) -> {r: coeff}.
    Out-of-range indices raise ``ValueError`` naming the offending term —
    a transcribed listing with a bad index must fail loudly, not wrap
    around via negative indexing into the wrong coefficient slot.
    """
    R = len(terms)
    if R < 1:
        raise ValueError(f"_from_terms({name}): empty term list")
    U = np.zeros((R, m, k), np.int8)
    V = np.zeros((R, k, n), np.int8)
    W = np.zeros((R, m, n), np.int8)
    for r, (al, bl) in enumerate(terms):
        for (i, l), c in al.items():
            if not (0 <= i < m and 0 <= l < k):
                raise ValueError(f"_from_terms({name}): term {r} indexes "
                                 f"A[{i},{l}] outside the {m}x{k} grid")
            U[r, i, l] = c
        for (l, j), c in bl.items():
            if not (0 <= l < k and 0 <= j < n):
                raise ValueError(f"_from_terms({name}): term {r} indexes "
                                 f"B[{l},{j}] outside the {k}x{n} grid")
            V[r, l, j] = c
    for (i, j), combo in cexprs.items():
        if not (0 <= i < m and 0 <= j < n):
            raise ValueError(f"_from_terms({name}): output C[{i},{j}] outside "
                             f"the {m}x{n} grid")
        for r, c in combo.items():
            if not (0 <= r < R):
                raise ValueError(f"_from_terms({name}): C[{i},{j}] references "
                                 f"product term {r} outside 0..{R - 1}")
            W[r, i, j] = c
    return LCMA(name, m, k, n, R, U, V, W)


def strassen() -> LCMA:
    """Strassen's <2,2,2>;7 (paper Fig. 1)."""
    t = [
        ({(0, 0): 1, (1, 1): 1}, {(0, 0): 1, (1, 1): 1}),      # M1=(A11+A22)(B11+B22)
        ({(1, 0): 1, (1, 1): 1}, {(0, 0): 1}),                 # M2=(A21+A22)B11
        ({(0, 0): 1}, {(0, 1): 1, (1, 1): -1}),                # M3=A11(B12-B22)
        ({(1, 1): 1}, {(1, 0): 1, (0, 0): -1}),                # M4=A22(B21-B11)
        ({(0, 0): 1, (0, 1): 1}, {(1, 1): 1}),                 # M5=(A11+A12)B22
        ({(1, 0): 1, (0, 0): -1}, {(0, 0): 1, (0, 1): 1}),     # M6=(A21-A11)(B11+B12)
        ({(0, 1): 1, (1, 1): -1}, {(1, 0): 1, (1, 1): 1}),     # M7=(A12-A22)(B21+B22)
    ]
    c = {
        (0, 0): {0: 1, 3: 1, 4: -1, 6: 1},
        (0, 1): {2: 1, 4: 1},
        (1, 0): {1: 1, 3: 1},
        (1, 1): {0: 1, 1: -1, 2: 1, 5: 1},
    }
    return _from_terms("strassen", 2, 2, 2, t, c)


def strassen_winograd() -> LCMA:
    """Winograd's variant of <2,2,2>;7 — 15 additions instead of 18.

    Lower ||U||_0+||V||_0+||W||_0 => cheaper Combine stages in the Decision
    Module's Table-II accounting.
    """
    t = [
        ({(0, 0): 1}, {(0, 0): 1}),                                   # P1=A11 B11
        ({(0, 1): 1}, {(1, 0): 1}),                                   # P2=A12 B21
        ({(0, 0): 1, (0, 1): 1, (1, 0): -1, (1, 1): -1}, {(1, 1): 1}),  # P3=S4 B22
        ({(1, 1): 1}, {(0, 0): 1, (0, 1): -1, (1, 0): -1, (1, 1): 1}),  # P4=A22 T4
        ({(1, 0): 1, (1, 1): 1}, {(0, 1): 1, (0, 0): -1}),            # P5=S1 T1
        ({(1, 0): 1, (1, 1): 1, (0, 0): -1}, {(0, 0): 1, (0, 1): -1, (1, 1): 1}),  # P6=S2 T2
        ({(0, 0): 1, (1, 0): -1}, {(1, 1): 1, (0, 1): -1}),           # P7=S3 T3
    ]
    c = {
        (0, 0): {0: 1, 1: 1},
        (0, 1): {0: 1, 5: 1, 4: 1, 2: 1},
        (1, 0): {0: 1, 5: 1, 6: 1, 3: -1},
        (1, 1): {0: 1, 5: 1, 6: 1, 4: 1},
    }
    return _from_terms("strassen-winograd", 2, 2, 2, t, c)


# Rank-23 <3,3,3> ternary scheme of the Laderman family. Recovered offline by
# a rounding-homotopy ALS decomposition of the <3,3,3> matmul tensor (seeded
# from Laderman 1976) and machine-verified against the tensor identity; the
# exact published coefficient listing was unavailable offline. Encoding:
# row-major base-3 digits, digit = coeff + 1.
_LADERMAN_U = (
    "000221122211011111111121111011221111111221111211111111011111221011111211"
    "111111221222100001111111121110111122112111110112111111111111122110122111"
    "112110111111122111121111111111112111111211111111111211111111112"
)
_LADERMAN_V = (
    "111121111101121111021200012201121111021111111211111111210112111112110111"
    "012111111111112111210022201111121201111121101111111211111111021111112210"
    "111112110111111012111211111111111121112111111121111111111111112"
)
_LADERMAN_W = (
    "101111111111221111111211111121221111121121111222221212112111212111111212"
    "112111112112111111111111011121111221111111221222212221121111121112212111"
    "111212111112112111211111111111121111111112111111111121111111112"
)


def _decode(s: str, shape) -> np.ndarray:
    return (np.frombuffer(s.encode(), dtype=np.uint8) - ord("1")).astype(np.int8).reshape(shape)


def laderman() -> LCMA:
    """Rank-23 <3,3,3> scheme (Laderman family). Machine-verified at build."""
    return LCMA(
        "laderman", 3, 3, 3, 23,
        _decode(_LADERMAN_U, (23, 3, 3)),
        _decode(_LADERMAN_V, (23, 3, 3)),
        _decode(_LADERMAN_W, (23, 3, 3)),
    )


# --------------------------------------------------------------------------
# Closure operations (correctness-preserving constructions)
# --------------------------------------------------------------------------

def tensor_product(l1: LCMA, l2: LCMA, name: str | None = None) -> LCMA:
    """Kronecker composition: recursive application of l2 inside l1."""
    m, k, n = l1.m * l2.m, l1.k * l2.k, l1.n * l2.n
    R = l1.R * l2.R

    def kron(X1, X2, d1, d2, e1, e2):
        # (R1,d1,e1) x (R2,d2,e2) -> (R1*R2, d1*d2, e1*e2)
        out = np.einsum("rde,sfg->rsdfeg", X1.astype(np.int16), X2.astype(np.int16))
        return out.reshape(R, d1 * d2, e1 * e2).astype(np.int8)

    U = kron(l1.U, l2.U, l1.m, l2.m, l1.k, l2.k)
    V = kron(l1.V, l2.V, l1.k, l2.k, l1.n, l2.n)
    W = kron(l1.W, l2.W, l1.m, l2.m, l1.n, l2.n)
    return LCMA(name or f"({l1.name})x({l2.name})", m, k, n, R, U, V, W)


def _require_matching(op: str, l1: LCMA, l2: LCMA, dims1, dims2, what: str):
    # bare asserts here disappeared under ``python -O``, letting incompatible
    # grids concatenate into a silently-wrong scheme
    if dims1 != dims2:
        raise ValueError(
            f"{op}: incompatible grids — {l1.name} <{l1.m},{l1.k},{l1.n}> vs "
            f"{l2.name} <{l2.m},{l2.k},{l2.n}> (need matching {what})")


def concat_n(l1: LCMA, l2: LCMA, name: str | None = None) -> LCMA:
    """C = [A B1 | A B2]: <m,k,n1+n2>; R1+R2."""
    _require_matching("concat_n", l1, l2, (l1.m, l1.k), (l2.m, l2.k), "(m, k)")
    m, k = l1.m, l1.k
    n = l1.n + l2.n
    R = l1.R + l2.R
    U = np.concatenate([l1.U, l2.U], axis=0)
    V = np.zeros((R, k, n), np.int8)
    V[: l1.R, :, : l1.n] = l1.V
    V[l1.R :, :, l1.n :] = l2.V
    W = np.zeros((R, m, n), np.int8)
    W[: l1.R, :, : l1.n] = l1.W
    W[l1.R :, :, l1.n :] = l2.W
    return LCMA(name or f"[{l1.name}|{l2.name}]n", m, k, n, R, U, V, W)


def concat_m(l1: LCMA, l2: LCMA, name: str | None = None) -> LCMA:
    """Row-stacked C: <m1+m2,k,n>; R1+R2."""
    _require_matching("concat_m", l1, l2, (l1.k, l1.n), (l2.k, l2.n), "(k, n)")
    k, n = l1.k, l1.n
    m = l1.m + l2.m
    R = l1.R + l2.R
    U = np.zeros((R, m, k), np.int8)
    U[: l1.R, : l1.m, :] = l1.U
    U[l1.R :, l1.m :, :] = l2.U
    V = np.concatenate([l1.V, l2.V], axis=0)
    W = np.zeros((R, m, n), np.int8)
    W[: l1.R, : l1.m, :] = l1.W
    W[l1.R :, l1.m :, :] = l2.W
    return LCMA(name or f"[{l1.name};{l2.name}]m", m, k, n, R, U, V, W)


def concat_k(l1: LCMA, l2: LCMA, name: str | None = None) -> LCMA:
    """C = A1 B1 + A2 B2 (K split): <m,k1+k2,n>; R1+R2."""
    _require_matching("concat_k", l1, l2, (l1.m, l1.n), (l2.m, l2.n), "(m, n)")
    m, n = l1.m, l1.n
    k = l1.k + l2.k
    R = l1.R + l2.R
    U = np.zeros((R, m, k), np.int8)
    U[: l1.R, :, : l1.k] = l1.U
    U[l1.R :, :, l1.k :] = l2.U
    V = np.zeros((R, k, n), np.int8)
    V[: l1.R, : l1.k, :] = l1.V
    V[l1.R :, l1.k :, :] = l2.V
    W = np.concatenate([l1.W, l2.W], axis=0)
    return LCMA(name or f"[{l1.name}+{l2.name}]k", m, k, n, R, U, V, W)


def transpose_dual(l: LCMA, name: str | None = None) -> LCMA:
    """From C = A B derive the <n,k,m> scheme via C^T = B^T A^T."""
    U = np.ascontiguousarray(np.transpose(l.V, (0, 2, 1)))
    V = np.ascontiguousarray(np.transpose(l.U, (0, 2, 1)))
    W = np.ascontiguousarray(np.transpose(l.W, (0, 2, 1)))
    out = LCMA(name or f"{l.name}^T", l.n, l.k, l.m, l.R, U, V, W)
    if not validate(out):
        raise ValueError(f"transpose_dual({l.name}) failed validation")
    return out


def cyclic(l: LCMA, name: str | None = None) -> LCMA:
    """Cyclic symmetry of the matmul tensor: <m,k,n>;R -> <k,n,m>;R.

    The correct index/transpose convention is found automatically by trying
    the small set of candidate permutations and validating (validation for
    grids <= 6 is microseconds, so this is both robust and cheap).
    """
    cands = []
    for (X, Y, Z) in itertools.permutations([l.U, l.V, l.W]):
        for tx in (False, True):
            for ty in (False, True):
                for tz in (False, True):
                    cands.append((X, Y, Z, tx, ty, tz))
    for X, Y, Z, tx, ty, tz in cands:
        U = np.transpose(X, (0, 2, 1)) if tx else X
        V = np.transpose(Y, (0, 2, 1)) if ty else Y
        W = np.transpose(Z, (0, 2, 1)) if tz else Z
        m2, k2 = U.shape[1], U.shape[2]
        if V.shape[1] != k2 or W.shape[1] != m2 or V.shape[2] != W.shape[2]:
            continue
        n2 = V.shape[2]
        if (m2, k2, n2) == (l.m, l.k, l.n) and not (tx or ty or tz):
            continue  # identity
        if (m2, k2, n2) != (l.k, l.n, l.m):
            continue
        cand = LCMA(name or f"cyc({l.name})", m2, k2, n2, l.R,
                    np.ascontiguousarray(U), np.ascontiguousarray(V),
                    np.ascontiguousarray(W))
        if validate(cand):
            return cand
    raise ValueError(f"no cyclic rotation of {l.name} found")


# --------------------------------------------------------------------------
# Library / registry
# --------------------------------------------------------------------------

@lru_cache(maxsize=1)
def library() -> dict[str, LCMA]:
    """All validated schemes, keyed by name. Hard-fails on invalid schemes."""
    out: dict[str, LCMA] = {}

    def add(l: LCMA, check: bool = True):
        if check and not validate(l):
            raise AssertionError(f"LCMA {l.name} {l.key} failed the tensor identity")
        out[l.name] = l
        return l

    s = add(strassen())
    sw = add(strassen_winograd())
    lad = add(laderman())

    # Rectangular borders via block concatenation (rank-optimal where known).
    s223 = add(concat_n(s, standard(2, 2, 1), "s223"))        # <2,2,3>;11 (Hopcroft-Kerr rank)
    add(cyclic(s223, "s232"))                                  # <2,3,2>;11
    add(cyclic(cyclic(s223), "s322"))                          # <3,2,2>;11
    s224 = add(tensor_product(s, standard(1, 1, 2), "s224"))   # <2,2,4>;14
    add(tensor_product(s, standard(1, 2, 1), "s242"))          # <2,4,2>;14
    add(tensor_product(s, standard(2, 1, 1), "s422"))          # <4,2,2>;14
    add(concat_n(s224, standard(2, 2, 1), "s225"))             # <2,2,5>;18
    add(concat_k(s223, standard(2, 1, 3), "s233"))             # <2,3,3>;17
    add(tensor_product(s, standard(1, 2, 2), "s244"))          # <2,4,4>;28
    add(tensor_product(s, standard(2, 2, 1), "s442"))          # <4,4,2>;28
    add(tensor_product(s, standard(2, 1, 2), "s424"))          # <4,2,4>;28

    # Two-level Strassen <4,4,4>;49 (paper §II-A) and Winograd-flavored twin.
    s444 = add(tensor_product(s, s, "s444"))
    add(tensor_product(sw, sw, "sw444"))
    # Laderman-based blowups.
    add(tensor_product(lad, standard(1, 1, 2), "lad336"))      # <3,3,6>;46
    s334 = add(concat_n(lad, standard(3, 3, 1), "lad334"))     # <3,3,4>;32
    add(concat_n(s334, standard(3, 3, 1), "lad335"))           # <3,3,5>;41
    # m,k,n in [2,5] coverage toward <5,5,5>.
    s445 = add(concat_n(s444, standard(4, 4, 1), "s445"))      # <4,4,5>;65
    s455 = add(concat_k(s445, standard(4, 1, 5), "s455"))      # <4,5,5>;85
    add(concat_m(s455, standard(1, 5, 5), "s555"))             # <5,5,5>;110
    add(tensor_product(s, s223, "s446"))                       # <4,4,6>;77
    return out


def get(name: str) -> LCMA:
    return library()[name]


def register(l: LCMA, overwrite: bool = False) -> LCMA:
    """Add a user scheme to the library (resolvable via ``FalconConfig.mode``
    / ``candidates``).

    Registration revalidates the tensor identity even though ``LCMA``'s
    constructor already vetted the coefficient *domain* (integer, int8
    range): an externally sourced listing (AlphaTensor standard-arithmetic,
    Smirnov ⟨3,3,6⟩) with |c| > 1 coefficients must prove it actually
    multiplies matrices before the dispatcher may pick it. The check is the
    exact Brent-equation verifier (``repro_torch.analysis.brent``): a rejection
    names the violated equations, not just "failed".
    """
    from repro_torch.analysis.brent import verify_or_raise
    verify_or_raise(l, context=f"register({l.name!r})")
    lib = library()
    if l.name in lib and not overwrite:
        raise ValueError(f"LCMA {l.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    lib[l.name] = l
    return l


def unregister(name: str) -> None:
    """Remove a user scheme (tests / plugin teardown). Unknown names no-op."""
    library().pop(name, None)


def candidates(max_grid: int = 5, min_saving: float = 0.0) -> list[LCMA]:
    """The Decision Module's candidate set S_LCMA (paper: m,k,n in [2,5])."""
    out = [
        l for l in library().values()
        if max(l.grid) <= max_grid and l.mult_saving > min_saving
    ]
    return sorted(out, key=lambda l: -l.mult_saving)
