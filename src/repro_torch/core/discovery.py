"""LCMA discovery: rounding-homotopy ALS over the matmul tensor (beyond-paper).

The paper consumes AlphaTensor's published schemes; this module can *find*
ternary rank-R decompositions directly, which is how this codebase recovered
its rank-23 <3,3,3> (Laderman-family) coefficients offline. Method:

  1. alternating least squares on U, V, W (each factor solve is linear),
  2. an increasing ridge penalty pulling entries toward round(x) in {-1,0,1}
     (the homotopy: lam 0 -> 3.0),
  3. final projection + EXACT verification of the Brent equations
     (``repro_torch.analysis.brent``: integer arithmetic, no float tolerance), so
     a candidate that survives this function is certified, not just
     numerically spot-checked, before it can reach ``algorithms.register()``.

Not a training-time component: a tool for growing ``S_LCMA`` beyond the
built-in library (``discover(3, 3, 3, 23)`` reproduces rank-23 in minutes on
one CPU core; small cases like <2,2,2>;7 take seconds). numpy only: the
same seed gives the reference package's U, V and W bit for bit.
"""
from __future__ import annotations

import logging

import numpy as np

from .lcma import LCMA, matmul_tensor

log = logging.getLogger(__name__)

__all__ = ["discover"]


def _target(m: int, k: int, n: int) -> np.ndarray:
    return matmul_tensor(m, k, n).astype(float)


def _solve(G: np.ndarray, Ep: np.ndarray, d1: int, d2: int, lam: float,
           target: np.ndarray, R: int) -> np.ndarray:
    X = np.zeros((R, d1, d2))
    A = G @ G.T + lam * np.eye(R)
    for p in range(d1):
        for q in range(d2):
            b = G @ Ep[p, q] + lam * target[:, p, q]
            X[:, p, q] = np.linalg.solve(A, b)
    return X


def discover(m: int, k: int, n: int, R: int, *, restarts: int = 20,
             als_iters: int = 60, seed: int = 0,
             init: LCMA | None = None) -> LCMA | None:
    """Search for a ternary <m,k,n>;R scheme. Returns None if not found."""
    E = _target(m, k, n)
    rng = np.random.default_rng(seed)
    rnd = lambda X: np.clip(np.round(X), -1, 1)

    def sweeps(U, V, W, lam, nit):
        for _ in range(nit):
            G = np.einsum("ria,rbj->riabj", U, V).reshape(R, -1)
            W = _solve(G, np.transpose(E, (4, 5, 0, 1, 2, 3)).reshape(m, n, -1),
                       m, n, lam, rnd(W), R)
            G = np.einsum("rbj,rcd->rbjcd", V, W).reshape(R, -1)
            U = _solve(G, E.reshape(m, k, -1), m, k, lam, rnd(U), R)
            G = np.einsum("ria,rcd->riacd", U, W).reshape(R, -1)
            V = _solve(G, np.transpose(E, (2, 3, 0, 1, 4, 5)).reshape(k, n, -1),
                       k, n, lam, rnd(V), R)
        return U, V, W

    for restart in range(restarts):
        if init is not None and restart == 0:
            U = init.U.astype(float)
            V = init.V.astype(float)
            W = init.W.astype(float)
        else:
            # gaussian init converges far more reliably than ternary+noise
            U = rng.normal(0, 0.7, (R, m, k))
            V = rng.normal(0, 0.7, (R, k, n))
            W = rng.normal(0, 0.7, (R, m, n))
        U, V, W = sweeps(U, V, W, 0.0, als_iters)
        for lam in (1e-4, 1e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0):
            U, V, W = sweeps(U, V, W, lam, max(als_iters // 2, 30))
        try:
            cand = LCMA(f"discovered-{m}{k}{n}r{R}", m, k, n, R,
                        rnd(U).astype(np.int8), rnd(V).astype(np.int8),
                        rnd(W).astype(np.int8))
        except ValueError:
            continue
        # Exact Brent-equation gate (falcon-check pass 1): only a scheme with
        # ZERO violated equations may escape discovery. A near-miss iterate
        # is logged with the violation count so a long search is debuggable.
        from repro_torch.analysis.brent import check_scheme
        findings = check_scheme(cand)
        if not findings:
            return cand
        log.debug("discover(%d,%d,%d;R=%d) restart %d: %s",
                  m, k, n, R, restart, findings[0].message)
    return None
