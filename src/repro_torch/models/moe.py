"""Mixture-of-Experts layer: top-k routing, capacity dispatch, grouped experts.

Per-expert projections run as **grouped batched FalconGEMM**
(``engine.grouped_matmul``): the E experts' capacity-C token blocks are one
planned grouped contraction. The Decision Module prices the whole
``E x (C, K) @ (K, N)`` group (``plan_batched``, one plan-cache key per
projection shape) and the backend runs the R*E intermediate products as one
grouped launch: on the ``"cuda"`` backend, Group Combine A of the
activations and Combine B of the expert stack (``batched_group_combine``),
then the grouped fused GEMM + Combine H against the per-expert B̃
(``batched_fused_gemm_combine_h``). A single layer's expert stacks may be
lifted to stacked :class:`~repro_torch.core.engine.PlannedWeight`\\ s
(``precombine_params``), which skips Combine B; a whole model's 4-D stacks
stay raw, as the reference leaves them.

The dispatch is the reference's token-drop (Switch-style) capacity scheme,
built from fixed-shape operations only (comparisons, ``cumsum``,
``index_put_(..., accumulate=True)`` into the ``(E, C, d)`` buffer, gathers
back), so a serving step that runs it still captures as one CUDA graph:
nothing reads the card back.

Under a mesh whose "model" axis divides the experts (``parallel.mesh``),
``moe_apply`` runs expert-parallel under the ``tp`` style (``_moe_ep``,
the counterpart of the reference's ``_moe_shardmap``), each data shard
routing its own tokens: each rank holds ``E / model`` experts and
the router's matching columns, all-gathers the router logits, dispatches
its tokens to its own experts only (``e_offset = rank * E_local``), and the
ranks' outputs are summed. Otherwise (one device, or experts that do not
divide the axis) it takes the dense path with every expert on every rank.

A serving step split over a "data" axis (each data rank computes its
contiguous share of the step's rows) routes as one device routes the whole
batch, inside :func:`route_over_data`: the capacity is the whole batch's,
and each rank offsets its slot positions by the tokens that the data ranks
before it routed to each expert (one all-gather of per-expert counts over
"data" a layer), so the same tokens drop as on one device, on either path.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.core import engine
from repro_torch.core.workloads import moe_capacity
from repro_torch.parallel import collectives as C
from repro_torch.parallel.mesh import current_mesh
from repro_torch.parallel.sharding import get_parallel_style
from .layers import dense_init, silu

__all__ = ["moe_init", "moe_apply", "route_over_data", "capacity_rows"]

# the whole step's rows while a data rank routes as one device (route_over_data)
_DATA_ROWS: contextvars.ContextVar[int | None] = contextvars.ContextVar("moe_data_rows",
                                                                        default=None)


@contextlib.contextmanager
def route_over_data(rows: int):
    """Within this context, on a mesh with a "data" axis of more than one
    rank, each data rank's MoE layers route as one device routes the step's
    whole batch of ``rows`` rows, of which the rank holds its contiguous
    share in rank order (``parallel.mesh.data_rows``): the capacity counts
    all ``rows``, and a token's slot in its expert counts the tokens of the
    data ranks before this one. Rows past ``rows`` (the padding of the last
    shares) come after every real row, so they never take a real token's
    slot. The serving engine and ``run_oneshot`` enter it around a step on
    a data mesh."""
    token = _DATA_ROWS.set(rows)
    try:
        yield
    finally:
        _DATA_ROWS.reset(token)


def _data_mesh():
    """The ambient mesh where :func:`route_over_data` is active and its data
    axis spans more than one rank, else None."""
    mesh = current_mesh()
    if _DATA_ROWS.get() is None or mesh is None or mesh.size("data") == 1:
        return None
    return mesh


def _slots_before(flat: torch.Tensor) -> torch.Tensor | None:
    """Under :func:`route_over_data` on a data mesh: per expert, the
    (token, choice) pairs that the data ranks before this one route there
    (``flat``: this rank's pairs, one-hot over the experts), from one
    all-gather of every rank's counts over "data"; else None."""
    mesh = _data_mesh()
    if mesh is None:
        return None
    counts = C.all_gather(flat.sum(0)[None], mesh, "data", dim=0)     # (data, E_local)
    return counts[:mesh.local_rank("data")].sum(0)


def capacity_rows(rows: int) -> int:
    """The rows an MoE layer of ``rows`` local rows takes its capacity at:
    the whole step's under :func:`route_over_data` on a data mesh, else its
    own."""
    return rows if _data_mesh() is None else _DATA_ROWS.get()


def moe_init(gen: torch.Generator, d: int, d_ff: int, num_experts: int, dtype,
             device, lead: tuple[int, ...] = ()) -> dict:
    """Router (d, E) and expert stacks (E, d, d_ff), (E, d_ff, d), each
    Normal(0, 1/d_in), with the leading dims ``lead`` (the layer stack)."""
    return {
        "router": dense_init(gen, (*lead, d, num_experts), dtype, device),
        "moe_gate": dense_init(gen, (*lead, num_experts, d, d_ff), dtype, device),
        "moe_up": dense_init(gen, (*lead, num_experts, d, d_ff), dtype, device),
        "moe_down": dense_init(gen, (*lead, num_experts, d_ff, d), dtype, device),
    }


def _expert_ffn(p_gate, p_up, p_down, xb: torch.Tensor) -> torch.Tensor:
    """xb: (E, C, d) -> (E, C, d). Grouped per-expert SwiGLU: each projection
    is ONE planned grouped contraction over all E experts (raw (E, K, N)
    stacks or stacked PlannedWeights)."""
    g = engine.grouped_matmul(xb, p_gate)
    u = engine.grouped_matmul(xb, p_up)
    return engine.grouped_matmul(silu(g) * u, p_down)


def _route(xt: torch.Tensor, router_logits: torch.Tensor, top_k: int):
    """(probs (T, E), renormalized gate values (T, k), expert indices (T, k))."""
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch load-balancing loss: E * sum(mean prob * top-1 share) (f32)."""
    me = probs.mean(dim=0)
    top1 = expert_idx[:, 0, None] == torch.arange(E, device=probs.device)
    ce = top1.to(torch.float32).mean(dim=0)
    return E * torch.sum(me * ce)


def _dispatch_compute_combine(xt, probs, gate_vals, expert_idx, C: int, p_gate, p_up,
                              p_down, E_local: int, e_offset: int, ffn=_expert_ffn):
    """Token-local dispatch into (E_local, C, d), FFN, weighted combine.

    Experts ``[e_offset, e_offset + E_local)`` are this call's; a token's
    slot in its expert is its rank among the (token, choice) pairs routed
    there, in token-major order, and pairs past capacity C are dropped (they
    add zeros at slot C-1, as in the reference). A per-choice loop (k is
    small), so no (T*k, d) replication of the tokens is materialized.
    ``ffn`` is the expert FFN (the plain per-expert loop of
    ``models.moe_ref`` in its tests). Under :func:`route_over_data` on a
    data mesh, each expert's slots start past those that the data ranks
    before this one filled.
    """
    T, d = xt.shape
    top_k = expert_idx.shape[1]
    e_rel = expert_idx - e_offset
    local = (e_rel >= 0) & (e_rel < E_local)
    e_rel = e_rel.clamp(0, E_local - 1)
    experts = torch.arange(E_local, device=xt.device)
    oh = ((e_rel[..., None] == experts) & local[..., None]).to(torch.int64)
    flat = oh.reshape(T * top_k, E_local)
    pos_all = torch.cumsum(flat, dim=0) - flat
    pos = (pos_all * flat).sum(-1).reshape(T, top_k)
    before = _slots_before(flat)
    if before is not None:
        pos = pos + before[e_rel]
    keep = local & (pos < C)
    # each (token, choice) pair's row in the flattened (E_local * C, d) buffer
    rows = e_rel * C + torch.where(keep, pos, C - 1)

    buf = torch.zeros((E_local * C, d), dtype=xt.dtype, device=xt.device)
    for s in range(top_k):
        w = keep[:, s].to(xt.dtype)[:, None]
        buf.index_put_((rows[:, s],), xt * w, accumulate=True)

    yb = ffn(p_gate, p_up, p_down, buf.view(E_local, C, d)).reshape(E_local * C, d)

    y = torch.zeros_like(xt)
    for s in range(top_k):
        contrib = yb[rows[:, s]]
        w = (gate_vals[:, s] * keep[:, s].to(gate_vals.dtype)).to(xt.dtype)
        y = y + contrib * w[:, None]
    return y


def _moe_dense(p: dict, x: torch.Tensor, top_k: int, C: int):
    B, S, d = x.shape
    E = p["router"].shape[-1]
    xt = x.reshape(B * S, d)
    logits = xt.float() @ p["router"].float()       # the router: plain f32, unplanned
    probs, gate_vals, expert_idx = _route(xt, logits, top_k)
    y = _dispatch_compute_combine(xt, probs, gate_vals, expert_idx, C, p["moe_gate"],
                                  p["moe_up"], p["moe_down"], E_local=E, e_offset=0)
    return y.reshape(B, S, d), _aux_loss(probs, expert_idx, E)


def _moe_ep(p: dict, x: torch.Tensor, top_k: int, C_local: int, mesh, E: int):
    """Expert-parallel MoE over the mesh's "model" axis: this rank's
    ``E / model`` experts and router columns, the router logits
    all-gathered, local dispatch at ``e_offset = rank * E_local``, the
    ranks' outputs summed. ``x`` is this rank's tokens: on a data axis each
    data shard routes its own, at the capacity of its tokens (the layer
    stack passes it), at least 8, as the reference's ``C_local``; under
    :func:`route_over_data` they are its share of the step's, routed as one
    device routes them, at the capacity of the step's tokens.

    Under autograd the tokens pass Megatron's *f* (each rank's experts and
    router columns give a partial gradient) and the output's sum is *g*.
    The routing's gradient is a partial too (a rank's gate values reach the
    output only through its own experts), so the logits' gather
    reduce-scatters it; the load-balancing loss, which every rank of the
    axis computes whole, enters that sum once (:class:`_ShareGrad`)."""
    B, S, d = x.shape
    nm = mesh.size("model")
    E_local = E // nm
    C_local = max(C_local, 8)
    xt = C.copy_to_axis(x.reshape(B * S, d), mesh)
    logits_loc = xt.float() @ p["router"].float()     # (T, E_local)
    logits = C.all_gather(logits_loc, mesh, dim=1)    # (T, E), rank order
    probs, gate_vals, expert_idx = _route(xt, logits, top_k)
    y = _dispatch_compute_combine(xt, probs, gate_vals, expert_idx, C_local, p["moe_gate"],
                                  p["moe_up"], p["moe_down"], E_local=E_local,
                                  e_offset=mesh.local_rank("model") * E_local)
    y = C.all_reduce(y, mesh)     # each token's k expert contributions over the ranks
    aux = _aux_loss(probs, expert_idx, E)
    if torch.is_grad_enabled() and aux.requires_grad:
        aux = _ShareGrad.apply(aux, nm)
    return y.reshape(B, S, d), aux


class _ShareGrad(torch.autograd.Function):
    """The identity, whose gradient is divided among ``n`` ranks that each
    compute the value whole and sum their gradients later."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_apply(p: dict, x: torch.Tensor, top_k: int, capacity_factor: float,
              deterministic_capacity: int | None = None, num_experts: int | None = None):
    """x: (B, S, d) -> (y, aux_loss). Token-drop capacity MoE (Switch-style).

    ``p``: ``router`` (d, E) and the stacks ``moe_gate``/``moe_up`` (E, d,
    d_ff), ``moe_down`` (E, d_ff, d), raw or PlannedWeights; on a mesh whose
    "model" axis divides E, this rank's ``E / model`` of them (its router
    columns and expert stacks). ``num_experts`` is the layer's E (default:
    the router's width, a layer that holds every expert). C is
    ``deterministic_capacity`` where given (the layer stack passes the
    shard-rounded capacity), else :func:`moe_capacity` of the B*S tokens.
    Under the ambient mesh the layer runs expert-parallel where the axis
    divides E (:func:`_moe_ep`), as the reference's ``_moe_shardmap``;
    otherwise the dense path. Dispatch policy comes from the context
    config.
    """
    B, S, _ = x.shape
    E = num_experts or p["router"].shape[-1]
    C_ = deterministic_capacity or moe_capacity(B * S, top_k, E, capacity_factor)
    mesh = current_mesh()
    nm = 1 if mesh is None else mesh.size("model")
    ep = nm > 1 and E % nm == 0 and get_parallel_style() == "tp"
    held = p["router"].shape[-1]
    if held != (E // nm if ep else E):
        raise ValueError(f"moe_apply: the router holds {held} of {E} experts; on a "
                         f"{nm}-way model axis this rank holds {E // nm if ep else E}")
    if ep:
        return _moe_ep(p, x, top_k, C_, mesh, E)
    return _moe_dense(p, x, top_k, C_)
