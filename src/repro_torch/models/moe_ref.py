"""The MoE layer's plain versions: the expert FFN without the grouped dispatch.

``eager_expert_ffn`` is the counterpart of the reference test's
``_eager_moe_ffn``: each expert's SwiGLU as ``torch.matmul`` products, no
FalconGEMM dispatch and no kernel. ``lcma_expert_ffn`` runs each grouped
projection through the kernels' plain versions of one LCMA
(``kernels.ref``), rounding each stage as the kernels do: the plain version
of the forced path. Both sit inside the same routing, dispatch and combine
as ``models.moe``. ``loop_moe_apply`` shares only the router and the
per-expert SwiGLU: its dispatch is its own (each expert's routed pairs
found one expert at a time, the first C kept, each kept token's output
added to its row). The tests and ``chip_smoke.py`` hold the grouped path
to them; serving never runs them.
"""
from __future__ import annotations

import torch

from repro_torch.core.lcma import LCMA
from repro_torch.kernels import ref
from .layers import silu
from .moe import _aux_loss, _dispatch_compute_combine, _route

__all__ = ["eager_expert_ffn", "lcma_expert_ffn", "eager_moe_apply", "loop_moe_apply"]


def eager_expert_ffn(p_gate, p_up, p_down, xb: torch.Tensor,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """xb (E, C, d) -> (E, C, d), one expert at a time, in ``compute_dtype``
    (default: ``xb``'s), rounded back to ``xb``'s dtype. Raw stacks only."""
    dt = compute_dtype or xb.dtype
    out = torch.empty_like(xb)
    for e in range(xb.shape[0]):
        x = xb[e].to(dt)
        h = silu(x @ p_gate[e].to(dt)) * (x @ p_up[e].to(dt))
        out[e] = (h @ p_down[e].to(dt)).to(xb.dtype)
    return out


def lcma_expert_ffn(l: LCMA):
    """The expert FFN (raw stacks) with each projection through the plain
    LCMA pipeline of ``l`` (``ref.grouped_lcma_matmul_ref``: Combine A and
    B, the product and Combine H, each summed in f32 and rounded once to
    the operands' dtype). Shapes must divide ``l``'s grid."""
    def ffn(p_gate, p_up, p_down, xb):
        g = ref.grouped_lcma_matmul_ref(xb, p_gate, l)
        u = ref.grouped_lcma_matmul_ref(xb, p_up, l)
        return ref.grouped_lcma_matmul_ref(silu(g) * u, p_down, l)
    return ffn


def eager_moe_apply(p: dict, x: torch.Tensor, top_k: int, C: int, ffn=eager_expert_ffn):
    """``models.moe.moe_apply``'s dense path at capacity ``C`` with the
    expert FFN ``ffn``: (y, aux, expert_idx)."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    xt = x.reshape(B * S, d)
    probs, gate_vals, expert_idx = _route(xt, xt.float() @ p["router"].float(), top_k)
    y = _dispatch_compute_combine(xt, probs, gate_vals, expert_idx, C, p["moe_gate"],
                                  p["moe_up"], p["moe_down"], E_local=E, e_offset=0,
                                  ffn=ffn)
    return y.reshape(B, S, d), _aux_loss(probs, expert_idx, E), expert_idx


def loop_moe_apply(p: dict, x: torch.Tensor, top_k: int, C: int,
                   compute_dtype: torch.dtype = torch.float32):
    """The MoE layer at capacity ``C`` with a dispatch of its own, raw stacks:
    for each expert, the (token, choice) pairs routed to it in token-major
    order, of which the first ``C`` are kept; each kept token's SwiGLU in
    ``compute_dtype``, weighted by its gate value, added to its row; the sum
    rounded once to ``x``'s dtype. Returns (y, expert_idx, dropped pairs)."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    xt = x.reshape(B * S, d)
    _, gate_vals, expert_idx = _route(xt, xt.float() @ p["router"].float(), top_k)
    y = torch.zeros(xt.shape, dtype=compute_dtype, device=x.device)
    dropped = 0
    for e in range(E):
        t, s = torch.nonzero(expert_idx == e, as_tuple=True)    # row-major: token-major
        dropped += max(0, t.numel() - C)
        t, s = t[:C], s[:C]
        xe = xt[t].to(compute_dtype)
        out = eager_expert_ffn(*(p[n][e, None] for n in ("moe_gate", "moe_up", "moe_down")),
                               xe[None])[0]
        y.index_add_(0, t, out * gate_vals[t, s, None].to(compute_dtype))
    return y.to(x.dtype).reshape(B, S, d), expert_idx, dropped
