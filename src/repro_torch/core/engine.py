"""FalconEngine: the unified dispatch surface for FalconGEMM.

* **Context-scoped config** — ``with use(cfg): ...`` installs a
  :class:`~repro_torch.core.falcon_gemm.FalconConfig` in a contextvar;
  ``current_config()`` resolves it anywhere below. Explicit ``cfg=``
  arguments remain as overrides.
* **General entry points** — :func:`dot_general` / :func:`einsum` normalize
  batched and transposed contractions down to the planned 2-D or grouped
  core, so attention contractions hit the Decision Module, not just dense
  layers.
* **Backends** — execution strategies resolve through the
  ``core.backends`` registry (``FalconConfig.backend`` is just a name).
* **Precombined weights** — :class:`PlannedWeight` carries a weight with its
  chosen LCMA and offline-combined B̃ (paper §IV-C "offline Combine B"),
  and under ``FalconConfig.quantize`` its int8 B̃q with block scales;
  ``dense``/``dot_general``/``matmul`` accept it, and
  :func:`precombine_params` lifts a whole param tree.
* **Bucket warmup** — :func:`warm_buckets` pre-plans a model's whole
  contraction inventory (``core.workloads``) at every serving bucket, so
  the continuous-batching engine's steps are plan-cache hits; with
  ``train=True`` also both backward shapes of each contraction.
* **Planned autodiff** — an LCMA-routed call that autograd records runs
  through a ``torch.autograd.Function`` core whose backward computes
  ``dA = g Bᵀ`` and ``dB = Aᵀ g`` as independently planned contractions
  (the reference's ``jax.custom_vjp`` cores): the CUDA kernels have no
  backward of their own, and the backward GEMMs meet the Decision Module.
  PlannedWeights are trainable, and :func:`refresh_planned_params` keeps B̃
  consistent across optimizer steps.

``repro_torch.api`` re-exports this surface.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
import warnings

import torch
import torch.nn.functional as F

from . import algorithms, backends, workloads
from .falcon_gemm import (FalconConfig, _pad2, plan, plan_batched, plan_training,
                          precombine_weights)
from .lcma import LCMA

__all__ = ["use", "current_config", "active_config", "config_scope",
           "matmul", "dense", "dot_general", "einsum", "grouped_matmul",
           "PlannedWeight", "plan_weight", "precombine_params",
           "refresh_planned_params", "warm_buckets", "projection_shapes",
           "grouped_expert_shapes", "FalconEngine"]


# ---------------------------------------------------------------------------
# Context-scoped configuration
# ---------------------------------------------------------------------------

_CONFIG: contextvars.ContextVar[FalconConfig | None] = \
    contextvars.ContextVar("falcon_config", default=None)


@contextlib.contextmanager
def use(cfg: FalconConfig):
    """Install ``cfg`` as the ambient FalconGEMM config for this context.

    Nests: the innermost ``use`` wins; on exit the previous config is
    restored (also on exception).
    """
    token = _CONFIG.set(cfg)
    try:
        yield cfg
    finally:
        _CONFIG.reset(token)


def active_config() -> FalconConfig | None:
    """The config installed by the innermost ``use``, or None outside any."""
    return _CONFIG.get()


def current_config() -> FalconConfig:
    """The ambient config: innermost ``use``, else the default FalconConfig."""
    return _CONFIG.get() or FalconConfig()


def _resolve(cfg: FalconConfig | None) -> FalconConfig:
    return cfg if cfg is not None else current_config()


@contextlib.contextmanager
def config_scope(default_factory):
    """Model-entry config resolution: the ambient config, else
    ``default_factory()`` (e.g. the model's own ``falcon_config_for``)."""
    with use(active_config() or default_factory()):
        yield


# ---------------------------------------------------------------------------
# Planned (precombined) weights
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlannedWeight:
    """A weight bundled with its chosen LCMA and offline-combined B̃.

    ``dense`` / ``matmul`` / ``dot_general`` accept a PlannedWeight wherever
    a (K, N) weight matrix is expected. ``algo is None`` marks a weight the
    Decision Module left on standard GEMM. Stacked weights (a leading layer
    dim) hold stacked tensors; ``pw[i]`` slices all of them.

    Planned under ``cfg.quantize``, the weight also carries the
    offline-quantized B̃q (int8) and its f32 block scales
    (``kernels.quant_combine.quantize_b_blockwise``), so the serve path can
    route through the backend's int8 ``apply_quant`` pipeline whenever the
    Decision Module picks the quantized tier at the actual M.
    """

    w: torch.Tensor | None    # original weight (K, N) [or (L, K, N)]; None if dropped
    bt: torch.Tensor | None   # precombined B̃ (R, K/k, N/n) [or (L, ...)]; None if GEMM
    algo: str | None          # LCMA scheme name; None => standard GEMM
    k: int                    # logical K of the matrix (trailing dims)
    n: int                    # logical N
    bq: torch.Tensor | None = None        # int8 B̃q (R, K/k, N/n) [or (L, ...)]
    b_scales: torch.Tensor | None = None  # f32 block scales (R, (K/k)/by, N/n)

    @property
    def lcma(self) -> LCMA | None:
        return algorithms.get(self.algo) if self.algo is not None else None

    @property
    def precombined(self) -> bool:
        return self.bt is not None

    @property
    def quantized(self) -> bool:
        return self.bq is not None

    def __getitem__(self, idx) -> "PlannedWeight":
        def take(t):
            return None if t is None else t[idx]
        return PlannedWeight(w=take(self.w), bt=take(self.bt), algo=self.algo,
                             k=self.k, n=self.n, bq=take(self.bq),
                             b_scales=take(self.b_scales))


def plan_weight(w: torch.Tensor, cfg: FalconConfig | None = None,
                m_hint: int = 1024, keep_weight: bool = True,
                grouped: bool = False) -> PlannedWeight:
    """Plan a static weight for serving: pick an LCMA and precombine B̃.

    The Decision Module is consulted with ``precombined_b=True`` at an
    activation-rows hint ``m_hint`` (use the serving prefill M). Weights of
    rank 3 are treated as stacked (leading layer dim) and combined per
    slice, in one grouped launch. ``grouped=True`` marks a rank-3 stack
    whose slices run together as one grouped contraction (MoE experts
    through ``grouped_matmul``): it is judged by ``plan_batched`` on the
    grouped problem, ``m_hint`` rows split evenly over the G slices (at
    least 8 each), as ``_apply_planned_grouped`` re-prices it when serving.
    Under ``cfg.quantize`` (on a backend with
    an int8 path) the int8 B̃q and its scales are baked too, whichever tier
    won at ``m_hint``: the serve-time re-decision picks fp or int8 at the
    actual M, so both must be available.
    ``keep_weight=False`` drops the raw weight; the precombined path is then
    always taken. B̃ (and B̃q) are made outside autograd: a kept raw weight
    is what trains (:func:`refresh_planned_params` re-derives B̃ from it),
    a dropped one leaves B̃ as the parameter.
    """
    cfg = _resolve(cfg)
    if w.ndim not in (2, 3):
        return PlannedWeight(w=w, bt=None, algo=None,
                             k=int(w.shape[-2]) if w.ndim >= 2 else 0,
                             n=int(w.shape[-1]))
    K, N = int(w.shape[-2]), int(w.shape[-1])
    dtype = str(w.dtype).removeprefix("torch.")
    if grouped and w.ndim == 3:
        G = int(w.shape[0])
        d = plan_batched(G, max(m_hint // G, 8), K, N, cfg, dtype, precombined_b=True)
    else:
        d = plan(m_hint, K, N, cfg, dtype, precombined_b=True)
    if not d.use_lcma:
        return PlannedWeight(w=w, bt=None, algo=None, k=K, n=N)
    l = d.algo
    bq = b_scales = None
    with torch.no_grad():
        if cfg.quantize and backends.get_backend(cfg.backend).apply_quant is not None:
            bq, b_scales = _quantize_weight(w, l)
        bt = precombine_weights(w, l)
    return PlannedWeight(w=w if keep_weight else None, bt=bt,
                         algo=l.name, k=K, n=N, bq=bq, b_scales=b_scales)


def _quantize_weight(w: torch.Tensor, l: LCMA, by: int | None = None):
    """Offline Combine B + blockwise int8 quantization of a weight (K, N),
    or of a stack (L, K, N) one slice at a time, so that a stack's f32 B̃
    never exists whole.

    Returns ``(B̃q int8 (R, K/k, N/n), f32 scales (R, (K/k)/by, N/n))``, each
    with the stack's leading dim. ``by`` defaults to
    ``kernels.quant_combine.scale_block`` of the combined K.
    """
    from repro_torch.kernels.quant_combine import quantize_b_blockwise, scale_block
    w3 = w if w.ndim == 3 else w[None]
    Y, Z = -(-w.shape[-2] // l.k), -(-w.shape[-1] // l.n)
    by = by or scale_block(Y)
    bq = torch.empty((w3.shape[0], l.R, Y, Z), dtype=torch.int8, device=w.device)
    scales = torch.empty((w3.shape[0], l.R, Y // by, Z), dtype=torch.float32,
                         device=w.device)
    for i in range(w3.shape[0]):
        bq[i], scales[i] = quantize_b_blockwise(
            _pad2(w3[i], l.k, l.n).contiguous(), l.V, by=by)
    return (bq, scales) if w.ndim == 3 else (bq[0], scales[0])


# The decoder's projections, the reference's list. MoE expert stacks lift to stacked
# PlannedWeights, applied per expert by the grouped dispatch; a whole
# model's experts are 4-D (layer, expert, K, N) and stay raw, as in the
# reference, since only rank 2 and 3 leaves are planned.
_DEFAULT_PRECOMBINE_PATTERNS = (
    "w_q", "w_k", "w_v", "w_o", "mlp_gate", "mlp_up", "mlp_down", "lm_head",
    "ssm_in", "ssm_out", "moe_gate", "moe_up", "moe_down",
)

# Stacks matching these run as ONE grouped contraction (not per slice), so
# plan_weight judges them with the grouped decision (plan_batched).
_GROUPED_PRECOMBINE_PATTERNS = ("moe_gate", "moe_up", "moe_down")


def precombine_params(params, cfg: FalconConfig | None = None,
                      m_hint: int = 1024, keep_weight: bool = True,
                      patterns: tuple[str, ...] = _DEFAULT_PRECOMBINE_PATTERNS):
    """Lift a nested-dict param tree into PlannedWeights for serving.

    Projection leaves whose path matches ``patterns`` are planned (and
    precombined where the Decision Module picks an LCMA); everything else —
    including leaves that are already ``PlannedWeight``s, so the lift is
    idempotent — passes through untouched. Returns (new_params, n_planned).
    """
    cfg = _resolve(cfg)
    n_planned = 0

    def walk(node, path):
        nonlocal n_planned
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if not isinstance(node, torch.Tensor) or node.ndim not in (2, 3) \
                or not any(pat in path for pat in patterns):
            return node
        grouped = node.ndim == 3 and any(pat in path for pat in
                                         _GROUPED_PRECOMBINE_PATTERNS)
        pw = plan_weight(node, cfg, m_hint=m_hint, keep_weight=keep_weight,
                         grouped=grouped)
        if pw.precombined:
            n_planned += 1
            return pw
        return node  # GEMM-bound weight: keep the raw tensor

    return walk(params, ""), n_planned


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def projection_shapes(arch) -> list[tuple[int, int]]:
    """Deprecated shim: the (K, N) dense-projection shapes of ``arch``; use
    ``workloads.dense_projection_shapes`` (or ``contraction_set`` /
    ``resolve_contractions``), the one source of a model's contractions."""
    warnings.warn(
        "falcon.projection_shapes is deprecated; use "
        "repro_torch.core.workloads.dense_projection_shapes / contraction_set "
        "(the workload registry) instead", DeprecationWarning, stacklevel=2)
    return workloads.dense_projection_shapes(arch)


def grouped_expert_shapes(arch, m_tokens: int) -> list[tuple[int, int, int, int]]:
    """Deprecated shim: the grouped (E, C, K, N) MoE contractions of
    ``arch`` at ``m_tokens`` rows; use ``workloads.grouped_moe_shapes``."""
    warnings.warn(
        "falcon.grouped_expert_shapes is deprecated; use "
        "repro_torch.core.workloads.grouped_moe_shapes (the workload registry) "
        "instead", DeprecationWarning, stacklevel=2)
    return workloads.grouped_moe_shapes(arch, m_tokens)


def _warm_contraction(c, cfg: FalconConfig, dtype: str, pre_algos: dict,
                      pre_algos_grouped: dict) -> int:
    """Plan one resolved registry contraction (+ its precombined variant)."""
    n = 0
    if c.group == 1:
        plan(c.m, c.k, c.n, cfg, dtype)
        n += 1
        if c.weight_static:
            d_pre = plan(c.m, c.k, c.n, cfg, dtype, precombined_b=True)
            if d_pre.use_lcma:
                pre_algos.setdefault((c.k, c.n), set()).add(d_pre.algo.name)
            n += 1
    else:
        plan_batched(c.group, c.m, c.k, c.n, cfg, dtype, shared_b=c.shared_b)
        n += 1
        if c.weight_static:
            d_pre = plan_batched(c.group, c.m, c.k, c.n, cfg, dtype, precombined_b=True,
                                 shared_b=c.shared_b)
            if d_pre.use_lcma:
                pre_algos_grouped.setdefault((c.group, c.k, c.n), set()).add(d_pre.algo.name)
            n += 1
    return n


def warm_buckets(cfg: FalconConfig | None, arch, buckets, dtype: str | None = None,
                 train: bool = False, mesh_shape: dict | None = None,
                 kv_len: int | None = None, spec_gamma: int | None = None) -> int:
    """Pre-plan the registry contraction set of ``arch`` at every bucket.

    The continuous-batching scheduler only ever launches bucket shapes, so
    running the Decision Module once per bucket x registry contraction —
    both the plain and the precombined-B variants for static-weight
    contractions — makes serve-time dispatch pure plan-cache hits. Returns
    the number of ``plan()``/``plan_batched()`` calls made.

    ``buckets`` entries are either an ``int`` — a flat activation-row count:
    warms the dense projections and the grouped MoE expert shapes at that M
    — or a ``(batch, seq)`` call
    context: resolves the whole inventory including the attention einsums
    and the SSD scan (or, at a decode step, recurrence) contractions
    (``seq == 1`` with ``kv_len`` set is a decode step against a
    length-``kv_len`` cache). The SSD ones are planned in float32, the
    dtype they run in (the reference plans them in ``dtype``, which misses
    them when the model is bf16). ``spec_gamma`` (with ``kv_len``) also warms,
    at every decode bucket ``(b, 1)``, the ``(b, γ+1)`` verify forward (lm
    head on every row) and the ``(b, 2)`` draft catch-up forward.
    ``train=True`` also pre-plans both backward contractions of each
    forward one (``decision.backward_shapes``, the grouped grad rules), so
    one warm pass at ``buckets=[(batch, seq)]`` makes a whole train step,
    forward and planned backward, run against a hot plan cache.
    ``mesh_shape`` warms the shapes each rank of that mesh contracts
    (``workloads.resolve_contractions(..., local=True)``: a data rank's
    ``ceil(b / d)`` rows of each bucket, tensor-parallel projections at
    their shard's K or N, attention over the local heads, the expert group
    and capacity of one shard), so a multi-device engine's ranks serve on
    plan hits too.
    """
    cfg = _resolve(cfg)
    dtype = dtype or str(getattr(arch, "dtype", "bfloat16"))
    flat = sorted({int(b) for b in buckets if not isinstance(b, tuple)})
    pairs = sorted({(int(b), int(s)) for b, s in
                    (b for b in buckets if isinstance(b, tuple))})
    pre_algos: dict[tuple[int, int], set[str]] = {}
    pre_algos_grouped: dict[tuple[int, int, int], set[str]] = {}
    contractions: list = []
    resolve = functools.partial(workloads.resolve_contractions, arch, train=train,
                                mesh_shape=mesh_shape, local=bool(mesh_shape))
    for M in flat:
        contractions += [c for c in resolve(1, M) if c.kind in ("dense", "grouped_moe")]
    for b, s in pairs:
        decode = kv_len is not None and s == 1
        contractions += resolve(b, s, kv_len=kv_len, decode=decode)
        if spec_gamma and decode:
            contractions += resolve(b, spec_gamma + 1, kv_len=kv_len, spec_verify=True)
            contractions += resolve(b, 2, kv_len=kv_len)
    # static-weight contractions first, so a shape shared between a weight
    # contraction and an activation one keeps its precombined variant
    contractions.sort(key=lambda c: not c.weight_static)
    n = 0
    seen: set[str] = set()
    for c in contractions:
        if c.key_shape() not in seen:
            seen.add(c.key_shape())
            # the SSD contractions run in float32 whatever the model's dtype
            cdt = "float32" if c.kind in workloads.F32_KINDS else dtype
            n += _warm_contraction(c, cfg, cdt, pre_algos, pre_algos_grouped)
    # The PlannedWeight apply re-decides at the actual M with the candidates
    # restricted to the weight's own scheme: a differently keyed plan (the
    # candidate set is part of the key). Pre-plan those restricted variants
    # for every scheme a bucket's precombined decision picked.
    if cfg.mode == "auto":
        planned: set[str] = set()
        for c in contractions:
            if not c.weight_static or c.key_shape() in planned:
                continue
            planned.add(c.key_shape())
            if c.group == 1:
                for a in sorted(pre_algos.get((c.k, c.n), ())):
                    plan(c.m, c.k, c.n, dataclasses.replace(cfg, candidates=(a,)), dtype,
                         precombined_b=True)
                    n += 1
            else:
                for a in sorted(pre_algos_grouped.get((c.group, c.k, c.n), ())):
                    plan_batched(c.group, c.m, c.k, c.n,
                                 dataclasses.replace(cfg, candidates=(a,)), dtype,
                                 precombined_b=True, shared_b=c.shared_b)
                    n += 1
    return n


def _apply_planned(x: torch.Tensor, pw: PlannedWeight,
                   cfg: FalconConfig) -> torch.Tensor:
    """x (..., K) @ PlannedWeight -> (..., N); serving fast path, and
    trainable: where autograd records the call, the planned cores route the
    gradient to the raw weight (or, dropped, to B̃ itself)."""
    *lead, K = x.shape
    if pw.algo is None:
        return torch.matmul(x, pw.w)
    hook = backends.get_backend(cfg.backend).dense_hook
    if hook is not None and pw.w is not None:
        # a layer-level placement (shard_map_local's rank-local product)
        # takes precedence over the precombined path, as in the reference
        out = hook(x, pw.w, cfg)
        if out is not None:
            return out
    x2 = x.reshape(-1, K)
    use_quant = False
    if cfg.mode == pw.algo or pw.w is None:
        use_pre = True           # forced scheme, or raw weight dropped
        use_quant = pw.quantized and cfg.quantize
    elif not cfg.enabled or cfg.mode == "gemm":
        use_pre = False
    else:
        # Re-decide for the *actual* M (decode M is tiny, prefill M is large)
        # with Combine B free; restrict candidates to the precombined scheme.
        # cfg.quantize rides through the replace, so the decision also picks
        # the precision tier: int8 routes to the baked quant buffers below.
        d = plan(x2.shape[0], K, pw.n,
                 dataclasses.replace(cfg, mode="auto", candidates=(pw.algo,)),
                 _dtype_name(x), precombined_b=True)
        use_pre = d.use_lcma
        use_quant = pw.quantized and d.quantized
    if not use_pre:
        return torch.matmul(x, pw.w)
    be = backends.get_backend(cfg.backend)
    train = cfg.planned_vjp and _grad_needed(x2, pw.w, pw.bt)
    if use_quant and be.apply_quant is not None:
        if train and pw.w is not None:
            out2 = _PlannedWeightQuantCore.apply(x2, pw.w, pw.bq, pw.b_scales, pw.lcma,
                                                 pw.n, cfg)
        else:
            out2 = be.apply_quant(x2, pw.bq, pw.b_scales, pw.lcma, pw.n, cfg)
    elif train and pw.w is not None:
        out2 = _PlannedWeightCore.apply(x2, pw.w, pw.bt, pw.lcma, pw.n, cfg)
    elif train:
        out2 = _PlannedWeightRotatedCore.apply(x2, pw.bt, pw.lcma, pw.n, cfg)
    else:
        out2 = be.apply_precombined(x2, pw.bt, pw.lcma, pw.n, cfg)
    return out2.reshape(*lead, pw.n)


def _apply_planned_grouped(a3: torch.Tensor, pw: PlannedWeight,
                           cfg: FalconConfig) -> torch.Tensor:
    """Grouped apply against a PlannedWeight: a3 (G, M, K) -> (G, M, N).

    A 2-D PlannedWeight is the hoisted case (its B̃ is shared by the group);
    a stacked one (``bt`` (G, R, K/k, N/n)) is applied per group element,
    still as one grouped contraction. The Decision Module re-prices the
    grouped problem at the actual (G, M), restricted to the weight's scheme.
    Trainable as :func:`_apply_planned` is.
    """
    G, M, K = a3.shape
    if pw.algo is None:
        return torch.matmul(a3, pw.w)
    stacked = pw.bt.ndim == 4
    if cfg.mode == pw.algo or pw.w is None:
        use_pre = True
    elif not cfg.enabled or cfg.mode == "gemm":
        use_pre = False
    else:
        d = plan_batched(G, M, K, pw.n,
                         dataclasses.replace(cfg, mode="auto",
                                             candidates=(pw.algo,)),
                         _dtype_name(a3), precombined_b=True,
                         shared_b=not stacked)
        use_pre = d.use_lcma
    if not use_pre:
        return torch.matmul(a3, pw.w)
    if cfg.planned_vjp and _grad_needed(a3, pw.w, pw.bt):
        if pw.w is not None:
            return _GroupedPlannedWeightCore.apply(a3, pw.w, pw.bt, pw.lcma, pw.n, cfg)
        return _PlannedWeightRotatedCore.apply(a3, pw.bt, pw.lcma, pw.n, cfg)
    be = backends.get_backend(cfg.backend)
    return be.apply_grouped_precombined(a3, pw.bt, pw.lcma, pw.n, cfg)


# ---------------------------------------------------------------------------
# Planned autodiff: the autograd cores
#
# Autograd through the raw combine / R-GEMM / combine graph would
# differentiate the *implementation* — and the CUDA kernels have no
# backward, so on the "cuda" backend it could not run at all (their
# wrappers refuse an operand that requires grad). The cores below
# differentiate the *contraction*: the forward runs the planned dispatch,
# the backward computes dA and dB as two independently planned contractions,
# each through plan(), the plan cache and the backend exactly like a
# forward call. A core runs only where autograd records the call (grad mode
# on, an operand requiring grad): that is where the backward shapes are
# priced, so inference (``torch.inference_mode`` serving, CUDA graphs) never
# prices or caches one. Forward and backward both run with grad mode off.
# ---------------------------------------------------------------------------

def _grad_needed(*ts) -> bool:
    """True where autograd records a call: grad mode on and an operand
    (None entries skipped) requiring grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _dispatch2d(a2: torch.Tensor, b2: torch.Tensor,
                cfg: FalconConfig) -> torch.Tensor:
    """Planned 2-D contraction: plan(), then the backend's LCMA or GEMM.

    As in the reference, a decision for the int8 tier runs the fp LCMA here
    (only ``use_lcma`` is read): int8 operands exist only for PlannedWeights.
    """
    M, K = a2.shape
    d = plan(M, K, b2.shape[1], cfg, _dtype_name(a2))
    if d.use_lcma:
        return backends.get_backend(cfg.backend).apply(a2, b2, d.algo, cfg)
    return torch.matmul(a2, b2)


def _dispatch_grouped(a3: torch.Tensor, b: torch.Tensor,
                      cfg: FalconConfig) -> torch.Tensor:
    """Planned grouped contraction: one plan_batched decision for the group.

    ``b`` is (K, N) shared by the group or (G, K, N) per group. An int8-tier
    decision runs the fp grouped LCMA, as in the reference.
    """
    G, M, K = a3.shape
    d = plan_batched(G, M, K, b.shape[-1], cfg, _dtype_name(a3),
                     shared_b=b.ndim == 2)
    if d.use_lcma:
        return backends.get_backend(cfg.backend).apply_grouped(a3, b, d.algo, cfg)
    return torch.matmul(a3, b)     # broadcasts the shared-b case


class _PlannedCore(torch.autograd.Function):
    """The planned 2-D core (the reference's ``_planned_core``): a2 (M, K)
    @ b2 (K, N); dA = g b2ᵀ (M, N, K) and dB = a2ᵀ g (K, M, N), each planned
    and cast back to its operand's dtype."""

    @staticmethod
    def forward(ctx, a2, b2, cfg):
        plan_training(a2.shape[0], a2.shape[1], b2.shape[1], cfg, _dtype_name(a2))
        ctx.cfg = cfg
        ctx.save_for_backward(a2, b2)
        return _dispatch2d(a2, b2, cfg)

    @staticmethod
    def backward(ctx, g):
        a2, b2 = ctx.saved_tensors
        need_a, need_b, _ = ctx.needs_input_grad
        da = _dispatch2d(g, b2.T, ctx.cfg).to(a2.dtype) if need_a else None
        db = _dispatch2d(a2.T, g, ctx.cfg).to(b2.dtype) if need_b else None
        return da, db, None


class _GroupedCore(torch.autograd.Function):
    """The planned grouped core (the reference's ``_grouped_core``): a3 (G,
    M, K) against b (K, N) shared by the group or (G, K, N). Both gradients
    are planned grouped contractions, except the shared operand's
    ``dB = Σ_g a3[g]ᵀ g3[g]``, the flattened 2-D problem (K, G·M) @ (G·M, N)."""

    @staticmethod
    def forward(ctx, a3, b, cfg):
        G, M, K = a3.shape
        N, dt, shared = b.shape[-1], _dtype_name(a3), b.ndim == 2
        plan_batched(G, M, N, K, cfg, dt, shared_b=shared)             # dA
        if shared:
            plan(K, G * M, N, cfg, dt)                                  # dB (2-D)
        else:
            plan_batched(G, K, M, N, cfg, dt)                           # dB
        ctx.cfg = cfg
        ctx.save_for_backward(a3, b)
        return _dispatch_grouped(a3, b, cfg)

    @staticmethod
    def backward(ctx, g3):
        a3, b = ctx.saved_tensors
        need_a, need_b, _ = ctx.needs_input_grad
        G, M, K = a3.shape
        da = db = None
        if b.ndim == 2:
            if need_a:
                da = _dispatch_grouped(g3, b.T, ctx.cfg).to(a3.dtype)
            if need_b:
                db = _dispatch2d(a3.reshape(G * M, K).T, g3.reshape(G * M, -1),
                                 ctx.cfg).to(b.dtype)
        else:
            if need_a:
                da = _dispatch_grouped(g3, b.transpose(1, 2), ctx.cfg).to(a3.dtype)
            if need_b:
                db = _dispatch_grouped(a3.transpose(1, 2), g3, ctx.cfg).to(b.dtype)
        return da, db, None


def _zeros_like_if(need: bool, t: torch.Tensor | None):
    return torch.zeros_like(t) if need and t is not None else None


class _PlannedWeightCore(torch.autograd.Function):
    """A PlannedWeight apply with its raw weight kept (the reference's
    trainable ``_pw_core``): the primal reads only B̃ (the serving path),
    the backward returns ``dw = x2ᵀ g`` and ``dx = g wᵀ`` as planned
    contractions against the raw weight (the Combine-B map is linear, so
    the B̃ cotangent transposes back to exactly ``dw``). B̃ gets a zero
    gradient; :func:`refresh_planned_params` re-derives it from ``w``."""

    @staticmethod
    def forward(ctx, x2, w, bt, l, n_logical, cfg):
        plan_training(x2.shape[0], x2.shape[1], n_logical, cfg, _dtype_name(x2))
        ctx.cfg = cfg
        ctx.save_for_backward(x2, w, bt)
        return backends.get_backend(cfg.backend).apply_precombined(x2, bt, l, n_logical, cfg)

    @staticmethod
    def backward(ctx, g):
        x2, w, bt = ctx.saved_tensors
        need_x, need_w, need_bt = ctx.needs_input_grad[:3]
        dx = _dispatch2d(g, w.T, ctx.cfg).to(x2.dtype) if need_x else None
        dw = _dispatch2d(x2.T, g, ctx.cfg).to(w.dtype) if need_w else None
        return dx, dw, _zeros_like_if(need_bt, bt), None, None, None


class _GroupedPlannedWeightCore(torch.autograd.Function):
    """The grouped PlannedWeight apply with its raw weight kept (the
    reference's trainable ``_pw_grouped_core``): a3 (G, M, K) against a
    shared weight w (K, N) or a stack (G, K, N). ``dx`` is a planned grouped
    contraction; ``dw`` too for a stack, and for a shared weight the
    flattened 2-D problem ``Σ_g a3[g]ᵀ g3[g]``. B̃ gets a zero gradient."""

    @staticmethod
    def forward(ctx, a3, w, bt, l, n_logical, cfg):
        G, M, K = a3.shape
        dt, stacked = _dtype_name(a3), w.ndim == 3
        plan_batched(G, M, n_logical, K, cfg, dt, shared_b=not stacked)
        if stacked:
            plan_batched(G, K, M, n_logical, cfg, dt)
        else:
            plan(K, G * M, n_logical, cfg, dt)
        ctx.cfg = cfg
        ctx.save_for_backward(a3, w, bt)
        return backends.get_backend(cfg.backend).apply_grouped_precombined(
            a3, bt, l, n_logical, cfg)

    @staticmethod
    def backward(ctx, g3):
        a3, w, bt = ctx.saved_tensors
        need_x, need_w, need_bt = ctx.needs_input_grad[:3]
        G, M, K = a3.shape
        dx = dw = None
        if w.ndim == 3:
            if need_x:
                dx = _dispatch_grouped(g3, w.transpose(1, 2), ctx.cfg).to(a3.dtype)
            if need_w:
                dw = _dispatch_grouped(a3.transpose(1, 2), g3, ctx.cfg).to(w.dtype)
        else:
            if need_x:
                dx = _dispatch_grouped(g3, w.T, ctx.cfg).to(a3.dtype)
            if need_w:
                dw = _dispatch2d(a3.reshape(G * M, K).T, g3.reshape(G * M, -1),
                                 ctx.cfg).to(w.dtype)
        return dx, dw, _zeros_like_if(need_bt, bt), None, None, None


def _pw_bwd_rotated(x: torch.Tensor, bt: torch.Tensor, g: torch.Tensor, l: LCMA):
    """Exact LCMA-structured backward against B̃ alone (raw weight dropped).

    With H_r = Ãt_r B̃t_r and C[i,j] = Σ_r W[r,i,j] H_r, the cotangents are

        G̃t_r  = Σ_ij W[r,i,j] G[i,j]            (Combine with W coefficients)
        dX[i,l] = Σ_r U[r,i,l] (G̃t_r B̃t_rᵀ)     (R batched GEMMs, Combine U)
        dB̃t_r  = Ãt_rᵀ G̃t_r                     (R batched GEMMs)

    — the rank-R scheme rotated onto the gradient, reusing the stored B̃:
    the LCMA identity, not an approximation, so training directly on B̃ is
    sound (the output is linear in B̃). ``x`` (..., M, K) and ``g`` (..., M,
    N) may carry a group dim; ``bt`` is (R, K/k, N/n), shared by the group
    (its gradient summed over it), or stacked (G, R, K/k, N/n). Plain
    ``torch.einsum``, as the reference writes it with ``jnp.einsum``.
    """
    *lead, Mrows, K = x.shape
    Ks, Ns = int(bt.shape[-2]), int(bt.shape[-1])
    xp = F.pad(x, (0, (-K) % l.k, 0, (-Mrows) % l.m))
    Ms = xp.shape[-2] // l.m
    gp = F.pad(g, (0, l.n * Ns - g.shape[-1], 0, (-Mrows) % l.m))
    U = torch.tensor(l.U, dtype=xp.dtype, device=x.device)
    W = torch.tensor(l.W, dtype=gp.dtype, device=x.device)
    Gt = torch.einsum("rij,...ixjz->...rxz", W, gp.reshape(*lead, l.m, Ms, l.n, Ns))
    At = torch.einsum("ril,...ixly->...rxy", U, xp.reshape(*lead, l.m, Ms, l.k, Ks))
    Hb = torch.einsum("...rxz,...ryz->...rxy", Gt, bt.to(Gt.dtype))    # G̃t_r B̃t_rᵀ
    dx = torch.einsum("ril,...rxy->...ixly", U.to(Hb.dtype), Hb) \
        .reshape(*lead, l.m * Ms, l.k * Ks)[..., :Mrows, :K].to(x.dtype)
    dbt = torch.einsum("...rxy,...rxz->...ryz", At, Gt)
    if dbt.ndim > bt.ndim:                      # a B̃ shared by the group
        dbt = dbt.sum(0)
    return dx, dbt.to(bt.dtype)


class _PlannedWeightRotatedCore(torch.autograd.Function):
    """A PlannedWeight apply whose raw weight was dropped
    (``keep_weight=False``, the reference's ``_pw_core`` and
    ``_pw_grouped_core`` with ``trainable=False``): B̃ *is* the parameter,
    and both gradients come from the rotated rank-R scheme
    (:func:`_pw_bwd_rotated`). 2-D (x (M, K)) or grouped (x (G, M, K))."""

    @staticmethod
    def forward(ctx, x, bt, l, n_logical, cfg):
        ctx.l = l
        ctx.save_for_backward(x, bt)
        be = backends.get_backend(cfg.backend)
        if x.ndim == 2:
            return be.apply_precombined(x, bt, l, n_logical, cfg)
        return be.apply_grouped_precombined(x, bt, l, n_logical, cfg)

    @staticmethod
    def backward(ctx, g):
        x, bt = ctx.saved_tensors
        dx, dbt = _pw_bwd_rotated(x, bt, g, ctx.l)
        return dx, dbt, None, None, None


class _PlannedWeightQuantCore(torch.autograd.Function):
    """A quantized PlannedWeight apply (the reference's ``_pw_quant_core``):
    the primal is the backend's int8 pipeline (#6/#7) against B̃q and its
    scales; the backward stays fp, ``dx`` and ``dw`` planned against the
    RAW weight, so quantization error never enters the gradient. B̃q (int8)
    gets none and the scales a zero one; :func:`refresh_planned_params`
    re-bakes both after each update."""

    @staticmethod
    def forward(ctx, x2, w, bq, b_scales, l, n_logical, cfg):
        plan_training(x2.shape[0], x2.shape[1], n_logical, cfg, _dtype_name(x2))
        ctx.cfg = cfg
        ctx.save_for_backward(x2, w, b_scales)
        return backends.get_backend(cfg.backend).apply_quant(x2, bq, b_scales, l,
                                                             n_logical, cfg)

    @staticmethod
    def backward(ctx, g):
        x2, w, b_scales = ctx.saved_tensors
        need_x, need_w, _, need_s = ctx.needs_input_grad[:4]
        dx = _dispatch2d(g, w.T, ctx.cfg).to(x2.dtype) if need_x else None
        dw = _dispatch2d(x2.T, g, ctx.cfg).to(w.dtype) if need_w else None
        return dx, dw, None, _zeros_like_if(need_s, b_scales), None, None, None


def _contract2d(a2: torch.Tensor, b2: torch.Tensor, cfg: FalconConfig) -> torch.Tensor:
    """A 2-D contraction through the dispatch, trainable: where autograd
    records it and the forward decision picks an LCMA, the planned core
    (the reference's ``_route_planned``); otherwise ``torch.matmul``, whose
    own backward is a plain GEMM, or the LCMA without a core
    (``planned_vjp=False``: autograd differentiates the combine graph,
    which the generated ``"torch"`` backend allows and the CUDA kernels
    refuse)."""
    if cfg.planned_vjp and _grad_needed(a2, b2):
        if plan(a2.shape[0], a2.shape[1], b2.shape[1], cfg, _dtype_name(a2)).use_lcma:
            return _PlannedCore.apply(a2, b2, cfg)
        return torch.matmul(a2, b2)
    return _dispatch2d(a2, b2, cfg)


def _contract_grouped(a3: torch.Tensor, b: torch.Tensor, cfg: FalconConfig) -> torch.Tensor:
    """A grouped contraction through the dispatch, trainable as
    :func:`_contract2d` is (the reference's ``_route_grouped``)."""
    if cfg.planned_vjp and _grad_needed(a3, b):
        G, M, K = a3.shape
        if plan_batched(G, M, K, b.shape[-1], cfg, _dtype_name(a3),
                        shared_b=b.ndim == 2).use_lcma:
            return _GroupedCore.apply(a3, b, cfg)
        return torch.matmul(a3, b)
    return _dispatch_grouped(a3, b, cfg)


def refresh_planned_params(params):
    """Re-derive every PlannedWeight's B̃ from its (just updated) raw weight.

    Planned gradients land on the raw weight (the B̃ gradient is zero), so
    after an optimizer step the stored B̃ is stale; Combine B is linear and
    cheap beside a train step, so the train steps re-run it here after each
    update (outside autograd). A quantized PlannedWeight re-bakes B̃q and its
    scales at the same K-block. Weights without a raw copy
    (``keep_weight=False``) train B̃ directly and pass through, as does
    every other leaf. Returns a new tree.
    """
    def refresh(node):
        if isinstance(node, dict):
            return {k: refresh(v) for k, v in node.items()}
        if not isinstance(node, PlannedWeight) or not node.precombined or node.w is None:
            return node
        lc = node.lcma
        with torch.no_grad():
            bt = precombine_weights(node.w, lc)
            if node.bq is None:
                return dataclasses.replace(node, bt=bt)
            by = node.bq.shape[-2] // node.b_scales.shape[-2]
            bq, b_scales = _quantize_weight(node.w, lc, by=by)
        return dataclasses.replace(node, bt=bt, bq=bq, b_scales=b_scales)

    return refresh(params)


# ---------------------------------------------------------------------------
# Dispatch entry points
# ---------------------------------------------------------------------------

def grouped_matmul(a: torch.Tensor, b, cfg: FalconConfig | None = None
                   ) -> torch.Tensor:
    """Grouped batched matmul ``out[g] = a[g] @ b[g]`` as one planned unit.

    ``a``: (G, M, K). ``b``: (K, N) shared across the group (Combine B
    hoisted, run once), (G, K, N) per group, or a :class:`PlannedWeight`.
    Differentiable: under ``cfg.planned_vjp`` the gradients are planned
    grouped contractions.
    """
    cfg = _resolve(cfg)
    if a.ndim != 3:
        raise ValueError(f"grouped_matmul: a must be (G, M, K), "
                         f"got {tuple(a.shape)}")
    if isinstance(b, PlannedWeight):
        return _apply_planned_grouped(a, b, cfg)
    G, M, K = a.shape
    if b.ndim not in (2, 3) or b.shape[-2] != K \
            or (b.ndim == 3 and b.shape[0] != G):
        raise ValueError(f"grouped_matmul: shapes do not conform: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    return _contract_grouped(a, b, cfg)


def matmul(a: torch.Tensor, b, cfg: FalconConfig | None = None) -> torch.Tensor:
    """``a @ b`` with FalconGEMM dispatch. ``a``: (..., M, K), ``b``: (K, N)
    or a :class:`PlannedWeight`. Differentiable end to end: under
    ``cfg.planned_vjp`` both backward GEMMs are planned contractions."""
    cfg = _resolve(cfg)
    if isinstance(b, PlannedWeight):
        return _apply_planned(a, b, cfg)
    *lead, M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"matmul: contracting dims differ: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    c = _contract2d(a.reshape(-1, K), b, cfg)
    return c.reshape(*lead, M, N)


def dense(x: torch.Tensor, w, cfg: FalconConfig | None = None) -> torch.Tensor:
    """Linear layer contraction: x (..., K) @ w (K, N) [w may be planned]."""
    cfg = _resolve(cfg)
    if isinstance(w, PlannedWeight):
        return _apply_planned(x, w, cfg)
    hook = backends.get_backend(cfg.backend).dense_hook
    if hook is not None:
        out = hook(x, w, cfg)
        if out is not None:
            return out
    *lead, K = x.shape
    return matmul(x.reshape(-1, K), w, cfg).reshape(*lead, w.shape[1])


def dot_general(a: torch.Tensor, b, dimension_numbers,
                cfg: FalconConfig | None = None) -> torch.Tensor:
    """``jax.lax.dot_general`` semantics with FalconGEMM dispatch.

    ``dimension_numbers`` is ``((a_contract, b_contract), (a_batch,
    b_batch))``; the output is (batch..., a_free..., b_free...). Free and
    contracting dims are transposed adjacent and flattened to a (M, K) x
    (K, N) problem: an unbatched contraction is priced by ``plan()``, a
    **batched** one as a whole group by ``plan_batched`` (one grouped
    decision for the batch, never per-element pricing). Under
    ``cfg.planned_vjp`` an LCMA-routed contraction that autograd records
    runs through the matching planned core.
    """
    cfg = _resolve(cfg)
    (ac, bc), (ab, bb) = dimension_numbers
    ac, bc, ab, bb = (tuple(int(i) for i in t) for t in (ac, bc, ab, bb))
    if isinstance(b, PlannedWeight):
        if ab or bb or ac != (a.ndim - 1,) or bc != (0,):
            raise ValueError(
                "PlannedWeight only supports the canonical dense contraction "
                f"(((a.ndim-1,), (0,)), ((), ())); got {((ac, bc), (ab, bb))}")
        return _apply_planned(a, b, cfg)
    a_free = tuple(i for i in range(a.ndim) if i not in ac and i not in ab)
    b_free = tuple(i for i in range(b.ndim) if i not in bc and i not in bb)
    M = math.prod(a.shape[i] for i in a_free)
    K = math.prod(a.shape[i] for i in ac)
    N = math.prod(b.shape[i] for i in b_free)
    batch_shape = tuple(a.shape[i] for i in ab)
    out_shape = batch_shape + tuple(a.shape[i] for i in a_free) \
        + tuple(b.shape[i] for i in b_free)
    at = a.permute(ab + a_free + ac)
    bt = b.permute(bb + bc + b_free)
    if not ab:
        c = _contract2d(at.reshape(M, K), bt.reshape(K, N), cfg)
    else:
        Bsz = math.prod(batch_shape)
        c = _contract_grouped(at.reshape(Bsz, M, K), bt.reshape(Bsz, K, N), cfg)
    return c.reshape(out_shape)


def einsum(subscripts: str, *operands, cfg: FalconConfig | None = None
           ) -> torch.Tensor:
    """``torch.einsum`` with FalconGEMM dispatch for two-operand contractions.

    Two-operand subscripts without ellipsis/repeats/sum-out reduce to
    :func:`dot_general` (and so hit the Decision Module); anything else
    falls back to ``torch.einsum`` unchanged.
    """
    if len(operands) == 2:
        a, b = operands
        parsed = _einsum_dimension_numbers(subscripts, a.ndim, b.ndim)
        if parsed is not None:
            dn, perm = parsed
            out = dot_general(a, b, dn, cfg=cfg)
            if perm != tuple(range(len(perm))):
                out = out.permute(perm)
            return out
    return torch.einsum(subscripts, *operands)


def _einsum_dimension_numbers(subscripts: str, a_ndim: int, b_ndim: int):
    """Two-operand einsum -> (dimension_numbers, output permutation) or None.

    None means "not expressible as a single dot_general" (ellipsis, repeated
    labels within an operand, summed-out free labels, rank mismatch).
    """
    subs = subscripts.replace(" ", "")
    if "." in subs:
        return None
    if "->" in subs:
        lhs, out = subs.split("->")
    else:
        lhs, out = subs, None
    terms = lhs.split(",")
    if len(terms) != 2:
        return None
    ta, tb = terms
    if len(ta) != a_ndim or len(tb) != b_ndim:
        return None
    if len(set(ta)) != len(ta) or len(set(tb)) != len(tb):
        return None
    if out is None:  # implicit mode: alphabetic order of non-shared labels
        out = "".join(sorted(c for c in set(ta + tb)
                             if (ta + tb).count(c) == 1))
    if len(set(out)) != len(out) or any(c not in ta + tb for c in out):
        return None
    shared = [c for c in ta if c in tb]
    batch = tuple(c for c in shared if c in out)
    contract = tuple(c for c in shared if c not in out)
    a_free = [c for c in ta if c not in tb]
    b_free = [c for c in tb if c not in ta]
    if any(c not in out for c in a_free + b_free):
        return None  # summed-out free label: not a plain contraction
    dn = ((tuple(ta.index(c) for c in contract),
           tuple(tb.index(c) for c in contract)),
          (tuple(ta.index(c) for c in batch),
           tuple(tb.index(c) for c in batch)))
    natural = list(batch) + a_free + b_free   # dot_general output order
    perm = tuple(natural.index(c) for c in out)
    return dn, perm


# ---------------------------------------------------------------------------
# The engine object: a bound config + the dispatch surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FalconEngine:
    """A FalconConfig bound to the dispatch surface.

    The module-level functions resolve their config from the ambient
    context; an engine pins one, for a service that juggles several
    hardware or policy profiles at once:

        eng = FalconEngine(FalconConfig(mode="strassen"))
        y = eng.dense(x, w)
        with eng.activate():     # or make it the ambient config
            y = dense(x, w)
    """

    config: FalconConfig = dataclasses.field(default_factory=FalconConfig)

    def activate(self):
        return use(self.config)

    def plan(self, M: int, K: int, N: int, dtype: str = "bfloat16",
             precombined_b: bool = False):
        return plan(M, K, N, self.config, dtype, precombined_b=precombined_b)

    def matmul(self, a, b):
        return matmul(a, b, cfg=self.config)

    def dense(self, x, w):
        return dense(x, w, cfg=self.config)

    def dot_general(self, a, b, dimension_numbers):
        return dot_general(a, b, dimension_numbers, cfg=self.config)

    def grouped_matmul(self, a, b):
        return grouped_matmul(a, b, cfg=self.config)

    def plan_batched(self, B: int, M: int, K: int, N: int,
                     dtype: str = "bfloat16", precombined_b: bool = False,
                     shared_b: bool = False):
        return plan_batched(B, M, K, N, self.config, dtype,
                            precombined_b=precombined_b, shared_b=shared_b)

    def einsum(self, subscripts, *operands):
        return einsum(subscripts, *operands, cfg=self.config)

    def plan_weight(self, w, **kw):
        return plan_weight(w, cfg=self.config, **kw)

    def precombine_params(self, params, **kw):
        return precombine_params(params, cfg=self.config, **kw)

    def plan_training(self, M: int, K: int, N: int, dtype: str = "bfloat16"):
        return plan_training(M, K, N, self.config, dtype)

    def warm_buckets(self, arch, buckets, **kw):
        return warm_buckets(self.config, arch, buckets, **kw)
