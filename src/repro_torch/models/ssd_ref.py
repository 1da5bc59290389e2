"""Plain versions of the SSD mixer (``models/ssd.py``), for the tests and
the chip check; the serving path never calls them.

* :func:`einsum_ssd_scan`: the chunked scan in float32 with ``torch.einsum``
  (three-operand contractions, the decays not folded into an operand), the
  form of the reference test's ``_ssd_scan_einsum_reference``.
* :func:`sequential_ssd`: the step-by-step recurrence ``s_t = s_{t-1} *
  exp(dt_t * -exp(A)) + B_t x_t dt_t``, ``y_t = C_t s_t``, one position at a
  time, the oracle of the reference's ``test_ssd_scan_matches_sequential``.
* :func:`plain_ssd_apply`: the whole mixer in float32 (``torch.matmul``
  projections around :func:`einsum_ssd_scan`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["einsum_ssd_scan", "sequential_ssd", "plain_ssd_apply"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def einsum_ssd_scan(x, dt, A, B_, C_, chunk: int, init_state=None):
    """Chunked SSD in float32 through ``torch.einsum``: (y (B, L, H, P),
    final state (B, H, N, P)), both float32."""
    Bb, L, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Lp = -(-L // chunk) * chunk
    pad = Lp - L
    x, dt, B_, C_ = (F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
                     for t in (x, dt, B_, C_))
    nc = Lp // chunk
    a = dt * (-torch.exp(A.float()))[None, None, :]

    def r(t):
        return t.reshape((Bb, nc, chunk) + tuple(t.shape[2:]))

    xc, ac = r(x * dt[..., None]), r(a)
    Bh = torch.repeat_interleave(r(B_), rep, dim=3)
    Ch = torch.repeat_interleave(r(C_), rep, dim=3)
    ac_t = ac.permute(0, 1, 3, 2)
    Lmat = torch.exp(_segsum(ac_t))
    scores = torch.einsum("bnihs,bnjhs->bnhij", Ch, Bh)
    y_diag = torch.einsum("bnhij,bnhij,bnjhp->bnihp", scores, Lmat, xc)
    decay_to_end = torch.exp(torch.sum(ac_t, -1, keepdim=True) - torch.cumsum(ac_t, -1))
    states = torch.einsum("bnhj,bnjhs,bnjhp->bnhsp", decay_to_end, Bh, xc)
    chunk_decay = torch.exp(torch.sum(ac_t, -1))
    s = torch.zeros((Bb, H, N, Pd), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    prev = []
    for n in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
    prev = torch.stack(prev, 1)
    dfs = torch.exp(torch.cumsum(ac_t, -1))
    y_off = torch.einsum("bnihs,bnhsp,bnhi->bnihp", Ch, prev, dfs)
    y = (y_diag + y_off).reshape(Bb, Lp, H, Pd)[:, :L]
    return y, s


def sequential_ssd(x, dt, A, B_, C_, init_state=None):
    """The SSD recurrence one position at a time, in float32: (y (B, L, H,
    P), final state (B, H, N, P))."""
    Bb, L, H, Pd = x.shape
    rep = H // B_.shape[2]
    x, dt, B_, C_ = (t.float() for t in (x, dt, B_, C_))
    s = torch.zeros((Bb, H, B_.shape[3], Pd), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    neg = -torch.exp(A.float())
    ys = []
    for t in range(L):
        Bt = torch.repeat_interleave(B_[:, t], rep, dim=1)           # (B, H, N)
        Ct = torch.repeat_interleave(C_[:, t], rep, dim=1)
        xdt = x[:, t] * dt[:, t, :, None]                            # (B, H, P)
        s = s * torch.exp(dt[:, t] * neg)[..., None, None] + Bt[..., None] * xdt[:, :, None]
        ys.append((Ct[..., None] * s).sum(2))
    return torch.stack(ys, 1), s


def plain_ssd_apply(p: dict, x: torch.Tensor, cfg, state=None, length_mask=None):
    """The mixer (``ssd.ssd_apply`` without a decode step) in float32:
    every weight and activation taken to float32, ``torch.matmul``
    projections, :func:`einsum_ssd_scan`. Returns (y, final state), float32."""
    B, L, _ = x.shape
    H, Pd, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    proj = torch.matmul(x.float(), p["ssm_in"].float())
    d_inner = H * Pd
    z, xs, B_, C_, dt = torch.split(proj, [d_inner, d_inner, G * N, G * N, H], dim=-1)
    xs = xs.reshape(B, L, H, Pd)
    dt = F.softplus(dt + p["ssm_dt_bias"].float()[None, None])
    if length_mask is not None:
        dt = dt * length_mask.float()[..., None]
    y, s = einsum_ssd_scan(xs, dt, p["ssm_A"], B_.reshape(B, L, G, N),
                           C_.reshape(B, L, G, N), cfg.ssm_chunk, init_state=state)
    y = y + xs * p["ssm_D"].float()[None, None, :, None]
    y = y.reshape(B, L, d_inner) * F.silu(z)
    return torch.matmul(y, p["ssm_out"].float()), s
