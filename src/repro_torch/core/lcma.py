"""LCMA: Lower-Complexity Matrix Multiplication Algorithm abstraction.

An LCMA is the tuple ``L = <m, k, n, R, U, V, W>`` (paper §II-A):

  * ``(m, k, n)``  — grid dimensions partitioning (M, K, N),
  * ``R``          — rank: number of submatrix multiplications (R < m*k*n),
  * ``U in S^{R x m x k}``, ``V in S^{R x k x n}``, ``W in S^{R x m x n}``
    — coefficient tensors, S = {-1, 0, 1} for every scheme in this library.

Correctness is the bilinear identity

    sum_r U[r,i,l] * V[r,l',j] * W[r,i',j'] == d(i,i') d(j,j') d(l,l')

which ``validate()`` checks exhaustively (it is exactly "this decomposition
expresses the <m,k,n> matrix-multiplication tensor with rank R").
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property, lru_cache

import numpy as np

__all__ = ["LCMA", "validate", "apply_reference", "matmul_tensor"]


def _check_coefficients(name: str, which: str, arr) -> np.ndarray:
    """Validate a coefficient tensor at construction (= registry) time.

    Every execution path (the CUDA kernels, the plain versions) bakes coefficients in as
    small integers; a float listing that silently truncated under the old
    ``astype(int8)`` computed wrong results without any error. Non-integer
    values and magnitudes outside the int8 range are rejected here, so a bad
    scheme fails at registration, not at matmul time.
    """
    a = np.asarray(arr)
    if a.dtype.kind == "f":
        if not np.all(a == np.round(a)):
            raise ValueError(
                f"LCMA {name}: {which} has non-integer coefficients "
                f"(worst offender: {a.flat[np.argmax(np.abs(a - np.round(a)))]!r}); "
                f"only integer coefficient tensors are supported")
        a = np.round(a)
    elif a.dtype.kind not in "iub":
        raise ValueError(
            f"LCMA {name}: {which} has unsupported coefficient dtype {a.dtype}")
    if np.any(np.abs(a.astype(np.int64)) > 127):
        raise ValueError(
            f"LCMA {name}: {which} coefficient magnitude "
            f"{int(np.max(np.abs(a.astype(np.int64))))} exceeds the supported "
            f"int8 range")
    return a.astype(np.int8)


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash => usable as a cache key
class LCMA:
    """A bilinear matrix-multiplication scheme ``<m,k,n,R,U,V,W>``."""

    name: str
    m: int
    k: int
    n: int
    R: int
    U: np.ndarray  # (R, m, k) int8
    V: np.ndarray  # (R, k, n) int8
    W: np.ndarray  # (R, m, n) int8

    def __post_init__(self):
        U = np.ascontiguousarray(_check_coefficients(self.name, "U", self.U))
        V = np.ascontiguousarray(_check_coefficients(self.name, "V", self.V))
        W = np.ascontiguousarray(_check_coefficients(self.name, "W", self.W))
        object.__setattr__(self, "U", U)
        object.__setattr__(self, "V", V)
        object.__setattr__(self, "W", W)
        if U.shape != (self.R, self.m, self.k):
            raise ValueError(f"{self.name}: U shape {U.shape} != {(self.R, self.m, self.k)}")
        if V.shape != (self.R, self.k, self.n):
            raise ValueError(f"{self.name}: V shape {V.shape} != {(self.R, self.k, self.n)}")
        if W.shape != (self.R, self.m, self.n):
            raise ValueError(f"{self.name}: W shape {W.shape} != {(self.R, self.m, self.n)}")
        U.setflags(write=False)
        V.setflags(write=False)
        W.setflags(write=False)

    # ---- structural properties used by the Decision Module (Table II) ----
    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.m, self.k, self.n)

    @cached_property
    def nnz_u(self) -> int:
        return int(np.count_nonzero(self.U))

    @cached_property
    def nnz_v(self) -> int:
        return int(np.count_nonzero(self.V))

    @cached_property
    def nnz_w(self) -> int:
        return int(np.count_nonzero(self.W))

    @property
    def mult_saving(self) -> float:
        """1 - R/(m*k*n): fraction of submatrix multiplications saved."""
        return 1.0 - self.R / (self.m * self.k * self.n)

    @property
    def key(self) -> str:
        return f"<{self.m},{self.k},{self.n}>;R={self.R}"

    @cached_property
    def fingerprint(self) -> str:
        """Content hash of the scheme *definition* (grid, rank, U/V/W).

        Two schemes with the same name but different coefficients get
        different fingerprints — the plan cache persists this next to the
        scheme name so `falcon-check` can prove a cached decision still
        refers to the definition that priced it.
        """
        h = hashlib.sha1()
        h.update(f"<{self.m},{self.k},{self.n}>;R={self.R};".encode())
        for t in (self.U, self.V, self.W):
            h.update(t.tobytes())
        return h.hexdigest()[:12]

    @cached_property
    def stability(self):
        """Static error-growth profile (``repro_torch.analysis.stability``).

        Lazily computed and cached on the (frozen, long-lived) scheme object;
        the Decision Module reads it to reject candidates whose error bound
        exceeds a call site's accuracy budget without touching the analyzer
        package at import time.
        """
        from repro_torch.analysis.stability import analyze
        return analyze(self)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"LCMA({self.name}, {self.key}, |U|={self.nnz_u}, |V|={self.nnz_v}, |W|={self.nnz_w})"

    def is_valid(self) -> bool:
        return validate(self)


@lru_cache(maxsize=64)
def matmul_tensor(m: int, k: int, n: int) -> np.ndarray:
    """The <m,k,n> matrix-multiplication tensor ``d(i,i') d(j,j') d(l,l')``.

    Axes ``(i, l, l', j, i', j')``, int64. The shared ground truth for
    ``validate``, the discovery ALS target and the exact Brent verifier
    (``repro_torch.analysis.brent``). Cached and marked read-only — callers that
    need a float/writable copy must copy.
    """
    expect = np.zeros((m, k, k, n, m, n), dtype=np.int64)
    for i in range(m):
        for a in range(k):
            for j in range(n):
                expect[i, a, a, j, i, j] = 1
    expect.setflags(write=False)
    return expect


def validate(l: LCMA, atol: float | None = None) -> bool:
    """Exhaustively check the bilinear identity for scheme ``l``.

    T[i,l, l',j, i',j'] = sum_r U[r,i,l] V[r,l',j] W[r,i',j'] must equal the
    <m,k,n> matmul tensor  d(i,i') d(j,j') d(l,l').

    The default (``atol=None``) is the EXACT integer path: ``LCMA``'s
    constructor guarantees int8 coefficients, so the identity is decided in
    int64 arithmetic with no tolerance — a pass is a certificate, not a
    float comparison (|T| <= R * 127**3 cannot overflow int64). Passing an
    explicit ``atol`` selects the float64 path, kept for validating
    *prospective* non-integer decompositions (e.g. un-rounded ALS iterates)
    before they are projected onto an integer scheme.
    """
    expect = matmul_tensor(l.m, l.k, l.n)
    if atol is None:
        U = l.U.astype(np.int64)
        V = l.V.astype(np.int64)
        W = l.W.astype(np.int64)
        T = np.einsum("ria,rbj,rcd->iabjcd", U, V, W)
        return bool(np.array_equal(T, expect))
    U = np.asarray(l.U, dtype=np.float64)
    V = np.asarray(l.V, dtype=np.float64)
    W = np.asarray(l.W, dtype=np.float64)
    T = np.einsum("ria,rbj,rcd->iabjcd", U, V, W)
    return bool(np.all(np.abs(T - expect) <= atol))


def apply_reference(l: LCMA, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Reference (numpy, staged Algorithm 1) application of an LCMA.

    Requires M % m == 0, K % k == 0, N % n == 0 (the framework pads before
    reaching this point). Used as the ground-truth oracle in tests.
    """
    M, K = A.shape
    K2, N = B.shape
    if K != K2:
        raise ValueError(f"apply_reference({l.name}): A {A.shape} and "
                         f"B {B.shape} disagree on the contraction dimension")
    if M % l.m or K % l.k or N % l.n:
        # a bare assert here vanished under ``python -O``, letting misaligned
        # operands reshape into garbage instead of raising
        raise ValueError(
            f"apply_reference({l.name}): shape (M={M}, K={K}, N={N}) is not "
            f"divisible by the scheme grid <{l.m},{l.k},{l.n}> — pad first")
    Ms, Ks, Ns = M // l.m, K // l.k, N // l.n
    # Partition into submatrices.
    Ap = A.reshape(l.m, Ms, l.k, Ks).transpose(0, 2, 1, 3)  # (m,k,Ms,Ks)
    Bp = B.reshape(l.k, Ks, l.n, Ns).transpose(0, 2, 1, 3)  # (k,n,Ks,Ns)
    # Stage 1/2: combine (einsum over the small coefficient tensors).
    At = np.einsum("rik,ikxy->rxy", l.U.astype(A.dtype), Ap)
    Bt = np.einsum("rkn,knyz->ryz", l.V.astype(B.dtype), Bp)
    # Stage 3: R batched multiplications.
    H = np.einsum("rxy,ryz->rxz", At, Bt)
    # Stage 4: combine H.
    Cp = np.einsum("rin,rxz->inxz", l.W.astype(A.dtype), H)
    return Cp.transpose(0, 2, 1, 3).reshape(M, N)
