"""Mamba-2 SSD (state-space duality) mixer: chunked scan and decode step.

The reference's mixer (not the published Mamba-2 block: no depthwise conv1d,
no gated norm before ``ssm_out``; the gate is ``y * silu(z)``). The in/out
projections are FalconGEMM-dispatched, and so are the chunk contractions:
scores, diagonal-block output, chunk-end states and the carried-state
contribution are each ONE 2-operand grouped contraction over
``B * n_chunks * H`` through ``engine.einsum`` (decay factors are folded
into an operand elementwise first), with the reference's subscripts, so
they reach ``plan_batched`` as the same groups. All four run in float32:
the scan casts its operands up. The decode recurrence routes its two
per-step contractions the same way (groups ``B * H``). Registry entries:
``kind="ssd_scan"`` / ``"ssd_decode"`` in ``core.workloads``.

The reference carries the state across chunks with ``jax.lax.scan``; here
it is a plain loop over the chunks, one ``addcmul`` launch per chunk
(``s[n+1] = states[n] + s[n] * decay[n]``), then one stack of the states
entering the chunks, so a captured CUDA graph holds it as it is and
autograd follows it.

Shapes: x (B, L, H, P) values; dt (B, L, H) step sizes; A (H,) decay rates;
B_, C_ (B, L, G, N) input/output projections with H % G == 0; state
(B, H, N, P).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.core.falcon_gemm import FalconConfig
from .layers import dense_init, silu

__all__ = ["ssd_init", "ssd_apply", "ssd_decode_step", "ssd_scan", "carry_states",
           "F32_LEAVES"]

# Leaves the model keeps in float32 whatever its dtype, as the reference does.
F32_LEAVES = ("ssm_A", "ssm_D", "ssm_dt_bias")


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < s <= i} a[..., s], and
    -inf above the diagonal (so its exp is 0). The -inf enters after the
    subtraction, so no -inf - -inf arises, even on a fully padded row."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_scan(x, dt, A, B_, C_, chunk: int, init_state=None):
    """Chunked SSD. Returns (y (B, L, H, P), final state (B, H, N, P)), both
    in ``x``'s dtype."""
    Bb, L, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Lp = -(-L // chunk) * chunk
    if Lp != L:
        # zero-pad the tail: dt=0 => decay 1 and no state contribution, so
        # the final state equals the unpadded one; padded outputs are sliced
        pad = Lp - L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    nc = Lp // chunk

    # fold dt into x (discretization) and build the log-decay per step
    xdt = x * dt[..., None]
    a = (dt * (-torch.exp(A))[None, None, :]).float()      # (B, L, H), negative

    def r(t):  # reshape into chunks
        return t.reshape((Bb, nc, chunk) + tuple(t.shape[2:]))

    xc, ac = r(xdt).float(), r(a)
    Bh = torch.repeat_interleave(r(B_), rep, dim=3).float()  # (B, nc, c, H, N)
    Ch = torch.repeat_interleave(r(C_), rep, dim=3).float()

    ac_t = ac.permute(0, 1, 3, 2)                 # (B, nc, H, c)
    Lmat = torch.exp(_segsum(ac_t))               # (B, nc, H, c, c)
    # intra-chunk (diagonal block) output: each einsum below is a planned
    # grouped contraction over B*nc*H (registry kind "ssd_scan")
    scores = engine.einsum("bnihs,bnjhs->bnhij", Ch, Bh)          # (B, nc, H, c, c)
    y_diag = engine.einsum("bnhij,bnjhp->bnihp", scores * Lmat, xc)

    # chunk-end states: the decay from position j to the end of its chunk,
    # folded into B elementwise, so states is one 2-operand contraction
    cum = torch.cumsum(ac_t, -1)
    total = torch.sum(ac_t, -1, keepdim=True)
    Bw = Bh * torch.exp(total - cum).permute(0, 1, 3, 2)[..., None]
    states = engine.einsum("bnjhs,bnjhp->bnhsp", Bw, xc)          # (B, nc, H, N, P)

    # inter-chunk recurrence: the state entering each chunk, and the last
    prev_states, final = carry_states(states, torch.exp(total[..., 0]), init_state)

    # the carried-in state's contribution to each position: the decay from
    # the chunk start folded into C elementwise, then one contraction
    Cw = Ch * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    y_off = engine.einsum("bnihs,bnhsp->bnihp", Cw, prev_states)

    y = (y_diag + y_off).reshape(Bb, Lp, H, Pd)[:, :L].to(x.dtype)
    return y, final.to(x.dtype)


def carry_states(states, chunk_decay, init_state=None):
    """The inter-chunk recurrence ``s[n+1] = s[n] * chunk_decay[n] +
    states[n]`` from ``s[0] = init_state`` (zeros if None), in float32.
    states: (B, nc, H, N, P) chunk-end states; chunk_decay: (B, nc, H).
    Returns (the state entering each chunk (B, nc, H, N, P), the final
    state (B, H, N, P)): one ``addcmul`` launch per chunk, then one stack of
    the states entering the chunks. Autograd follows every step (an op
    with ``out=`` it would not)."""
    Bb, nc, H, N, Pd = states.shape
    s = (torch.zeros((Bb, H, N, Pd), dtype=torch.float32, device=states.device)
         if init_state is None else init_state.float())
    states_t = states.transpose(0, 1)
    decay = chunk_decay.transpose(0, 1)[..., None, None]           # (nc, B, H, 1, 1)
    carried = [s]
    for n in range(nc):
        carried.append(torch.addcmul(states_t[n], carried[n], decay[n]))
    return torch.stack(carried[:nc], dim=1), carried[nc]


def ssd_decode_step(x, dt, A, B_, C_, state):
    """Single-token recurrence. x: (B, 1, H, P); state: (B, H, N, P).
    Returns (y (B, 1, H, P), new state), both in ``x``'s dtype."""
    a = torch.exp(dt[:, 0] * (-torch.exp(A))[None, :])            # (B, H)
    G = B_.shape[2]
    rep = x.shape[2] // G
    Bh = torch.repeat_interleave(B_[:, 0], rep, dim=1).float()    # (B, H, N)
    Ch = torch.repeat_interleave(C_[:, 0], rep, dim=1).float()
    xdt = (x[:, 0] * dt[:, 0, :, None]).float()
    # the state update (outer product) and the readout are planned grouped
    # contractions over B*H (registry kind "ssd_decode")
    new_state = (state.float() * a[..., None, None]
                 + engine.einsum("bhs,bhp->bhsp", Bh, xdt))
    y = engine.einsum("bhs,bhsp->bhp", Ch, new_state)
    return y[:, None].to(x.dtype), new_state.to(x.dtype)


def ssd_init(gen: torch.Generator, d_model: int, ssm_state: int, n_heads: int,
             head_dim: int, n_groups: int, dtype, device,
             lead: tuple[int, ...] = ()) -> dict:
    """The mixer's leaves with the leading dims ``lead`` (the layer stack):
    ``ssm_in`` packs [z (d_inner gate) | x (d_inner) | B (G*N) | C (G*N) |
    dt (H)]; ``ssm_A``, ``ssm_D`` and ``ssm_dt_bias`` are float32 (zeros,
    ones, zeros), as in the reference."""
    d_inner = n_heads * head_dim
    d_in_proj = 2 * d_inner + 2 * n_groups * ssm_state + n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ssm_in": dense_init(gen, (*lead, d_model, d_in_proj), dtype, device),
        "ssm_out": dense_init(gen, (*lead, d_inner, d_model), dtype, device),
        "ssm_A": torch.zeros((*lead, n_heads), **f32),      # log decay init ~ 1
        "ssm_D": torch.ones((*lead, n_heads), **f32),
        "ssm_dt_bias": torch.zeros((*lead, n_heads), **f32),
    }


def ssd_apply(p: dict, x: torch.Tensor, cfg, fcfg: FalconConfig | None = None,
              state=None, decode: bool = False, length_mask=None):
    """x: (B, L, d_model) -> (y, new_state).

    ``length_mask`` (B, L) zeroes dt on padded positions (dt=0 => decay 1,
    no state contribution: the scan's own tail-padding rule), so a
    right-padded serve prefill ends in the exact unpadded state. Dispatch
    policy comes from the context config; ``fcfg`` is a deprecated
    per-call override.
    """
    with engine.deprecated_fcfg(fcfg, "ssd_apply"):
        return _ssd_apply(p, x, cfg, state, decode, length_mask)


def _ssd_apply(p, x, cfg, state, decode, length_mask):
    B, L, _ = x.shape
    H, Pd, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    proj = engine.dense(x, p["ssm_in"])
    d_inner = H * Pd
    z = proj[..., :d_inner]                                        # gate branch
    off = d_inner
    xs = proj[..., off:off + d_inner].reshape(B, L, H, Pd)
    off += d_inner
    B_ = proj[..., off:off + G * N].reshape(B, L, G, N)
    off += G * N
    C_ = proj[..., off:off + G * N].reshape(B, L, G, N)
    off += G * N
    dt = F.softplus(proj[..., off:].float() + p["ssm_dt_bias"][None, None])  # (B, L, H)
    if length_mask is not None:
        dt = dt * length_mask.float()[..., None]
    if decode:
        y, new_state = ssd_decode_step(xs, dt, p["ssm_A"], B_, C_, state)
    else:
        y, new_state = ssd_scan(xs, dt, p["ssm_A"], B_, C_, cfg.ssm_chunk,
                                init_state=state)
    y = y + xs * p["ssm_D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, L, d_inner) * silu(z)                      # mamba2 output gate
    return engine.dense(y, p["ssm_out"]), new_state
