"""Decoder LM, all six families (dense, MoE, SSM, hybrid, and the audio and
vlm frontends): init, cache, forward, logits.

Params are a nested dict of tensors with the reference's layout: ``embed``
(Vp, d), ``layers`` holding every per-layer leaf stacked on a leading layer
dim (an MoE layer's ``moe`` group in place of ``mlp``: the router (L, d, E)
and the expert stacks (L, E, K, N); an SSM layer's ``ssm`` group in place of
attention and MLP; a hybrid layer's ``ssm`` group and its two branch norms
beside attention), ``final_norm``. The audio family (musicgen) has one
embedding table and one untied LM head per codebook, ``embed`` (CB, Vp, d)
and ``lm_head`` (CB, d, Vp): its tokens are (B, S, CB), their embeddings
are summed and its logits are (B, S, CB, Vp). The vlm family (pixtral)
takes precomputed patch embeddings (B, P, d), prepended to the text at
positions 0..P-1. The layer stack is a Python loop over
slices of it. All projections, the expert FFN, the tied LM head, the
attention contractions and the SSD scan's contractions are
FalconGEMM-dispatched; the MoE router is a plain f32 product, as in the
reference. The cache holds attention K/V and, for the SSM and hybrid
families, the recurrent ``state``; every entry is written in place.

On a mesh (``parallel.mesh.use_mesh``; params sharded by
``parallel.sharding.shard_params``) every rank runs this code on its
shard: the vocab-sharded embedding looks up the ids in its range and sums
over the model axis, an attention block over the local q heads (where they
divide the axis; with whole K/V where the KV heads do not, each q head
reading its own KV head) and the MLP over the local d_ff each end in one
all-reduce after the row-parallel ``w_o`` / ``mlp_down``, the LM head's
vocab shards are all-gathered, the MoE layer runs expert-parallel
(``models.moe``), and the cache holds the KV heads the rank holds. What a
layer holds whole needs no collective. Which it is, is read from the shapes
of the leaves against the config.

In training the collectives are differentiable: a column-parallel block's
input passes Megatron's *f* (identity forward, all-reduce backward), the
row-parallel all-reduce is *g* (identity backward), the LM head's gather
gives each rank its vocab slice of the gradient. Leaves placed over
"data" (ZeRO-3, ``fsdp``) or over ("data", "model") (``fsdp_only``) under
the ambient placement (``parallel.sharding.use_placement``) are gathered
at use, a layer's inside its remat function, so a recompute gathers again
and no whole weight outlives its layer; each gather's backward
reduce-scatters the gradient back to the shard. Whole ``w_k``/``w_v``
beside a rank's q heads pass *f* too: each rank's gradient of them covers
only the KV heads its q heads read, and *f* sums it over the model axis.

Training: :func:`lm_loss` is the chunked cross-entropy over the LM head
plus 0.01 times the MoE layers' load-balancing loss. Under autograd each
layer is recomputed in backward (``cfg.remat``, ``torch.utils.checkpoint``;
``cfg.remat_policy="dots"`` keeps its 2-D products' outputs,
``layers.remat``) and the stacked leaves are unbound once per forward, so
autograd stacks their gradients once. A layer with ``d_ff == 0`` has no MLP
and adds zeros, as the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.configs.base import FAMILIES, ModelConfig
from repro_torch.core import engine
from repro_torch.core.falcon_gemm import FalconConfig
from repro_torch.core.workloads import layer_capacity
from repro_torch.parallel import collectives as C
from repro_torch.parallel.mesh import current_mesh
from repro_torch.parallel.sharding import (attention_split, current_placement, gather_param,
                                           gather_tree, unstack_placement)
from repro_torch.tree import tree_leaves, tree_map
from . import layers as L
from . import moe as MOE
from . import ssd as SSD

__all__ = ["init_params", "forward", "init_cache", "falcon_config_for",
           "compute_logits", "padded_vocab", "layer_params", "chunked_xent", "lm_loss"]


def falcon_config_for(cfg: ModelConfig) -> FalconConfig:
    """The FalconGEMM policy for this model. No shard scaling: on a mesh
    each rank contracts local shapes already (the reference's
    ``falcon_config_for(cfg, mesh_shape)`` sets ``shards`` because its
    GSPMD traces global ones)."""
    return FalconConfig(enabled=cfg.use_falcon, mode=cfg.falcon_mode,
                        backend=cfg.falcon_backend)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; the port runs {FAMILIES}")


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (granite's 49155 -> 49408)."""
    return -(-cfg.vocab_size // 256) * 256


# Embedding rows drawn per float32 block of ``init_params``.
_EMBED_ROWS = 8192


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Random weights at the config's widths, made on ``device`` from a
    seeded generator (not the reference's numbers: the RNGs differ). Each
    leaf is allocated in the config's dtype and drawn in float32 pieces of
    at most one layer slice (the embedding: ``_EMBED_ROWS`` rows), so the
    largest transient is one slice, not a whole stacked leaf (an expert
    stack: one expert of one layer). The SSD leaves ``ssm_A``, ``ssm_D`` and
    ``ssm_dt_bias`` are float32, as in the reference. The audio family's
    ``embed`` (CB, Vp, d) is drawn in blocks of rows over all codebooks, its
    ``lm_head`` (CB, d, Vp) one codebook at a time, Normal(0, 1/d)."""
    _check_family(cfg)
    # the meta device (shapes only, the dry run) has no generator: a CPU one
    # stands in, and nothing is drawn there
    gen = torch.Generator(device="cpu" if torch.device(device).type == "meta" else device)
    gen.manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    Lc, d = cfg.num_layers, cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Vp = padded_vocab(cfg)
    ones = lambda *s: torch.ones(s, dtype=dt, device=device)  # noqa: E731
    dense = lambda *s: L.dense_init(gen, s, dt, device)        # noqa: E731
    ssm = lambda: SSD.ssd_init(gen, d, cfg.ssm_state, cfg.ssm_heads,  # noqa: E731
                               cfg.ssm_head_dim, cfg.ssm_groups, dt, device, lead=(Lc,))
    layers = {"ln1": ones(Lc, d)}
    if cfg.family == "ssm":                 # attention-free and MLP-free
        layers["ssm"] = ssm()
    else:
        layers["attn"] = {"w_q": dense(Lc, d, H * hd), "w_k": dense(Lc, d, Hkv * hd),
                          "w_v": dense(Lc, d, Hkv * hd), "w_o": dense(Lc, H * hd, d)}
        if cfg.family == "hybrid":
            layers.update(ssm=ssm(), attn_norm=ones(Lc, d), ssm_norm=ones(Lc, d))
        layers["ln2"] = ones(Lc, d)
        if cfg.family == "moe":
            layers["moe"] = MOE.moe_init(gen, d, cfg.d_ff, cfg.num_experts, dt, device,
                                         lead=(Lc,))
        elif cfg.d_ff == 0:
            pass                            # no MLP: the layer adds zeros
        elif cfg.mlp_type == "gelu":
            layers["mlp"] = {"mlp_up": dense(Lc, d, cfg.d_ff),
                             "mlp_down": dense(Lc, cfg.d_ff, d)}
        else:
            layers["mlp"] = {"mlp_gate": dense(Lc, d, cfg.d_ff),
                             "mlp_up": dense(Lc, d, cfg.d_ff),
                             "mlp_down": dense(Lc, cfg.d_ff, d)}
    audio = cfg.frontend == "audio_codebooks"
    CB = cfg.num_codebooks if audio else 1
    # in blocks of rows: gemma3's f32 embedding alone would be 5.6 GB
    embed = L.normal_init(gen, (CB * Vp, d), lambda w: w * 0.02, dt, device,
                          rows=_EMBED_ROWS)
    params = {
        "embed": embed.view(CB, Vp, d) if audio else embed,
        "layers": layers,
        "final_norm": ones(d),
    }
    if audio:
        params["lm_head"] = dense(CB, d, Vp)
    elif not cfg.tie_embeddings:
        params["lm_head"] = dense(d, Vp)
    return params


def layer_params(stacked, i: int):
    """Slice layer ``i`` out of the stacked per-layer tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _unbind_layers(stacked, n: int) -> list:
    """The stacked per-layer tree as ``n`` layer trees, each leaf (and each
    PlannedWeight's tensors) unbound once. Under autograd, slicing layer i
    of a stacked leaf n times would make each slice's backward allocate a
    zero tensor the size of the whole stack and add into it; one unbind's
    backward stacks the n gradients once."""
    parts = tree_map(torch.unbind, stacked)
    return [tree_map(lambda ts, i=i: ts[i], parts) for i in range(n)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               dtype=None) -> dict:
    """Zeroed cache: attention K/V (L, B, max_len, Hkv, hd) for every family
    with attention, the recurrent SSD ``state`` (L, B, H, N, P) for the SSM
    and hybrid ones. Under a mesh whose model axis splits the KV heads, Hkv
    is the rank's local KV heads (where it splits only the q heads, all of
    them: a rank's q heads read them from its whole K/V)."""
    dt = getattr(torch, dtype or cfg.dtype)
    cache = {}
    if cfg.family != "ssm":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads // _attn_split(cfg)[1],
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    if cfg.family in ("ssm", "hybrid"):
        cache["state"] = torch.zeros((cfg.num_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                                      cfg.ssm_head_dim), dtype=dt, device=device)
    return cache


def _ssd(lp, h, cfg: ModelConfig, cache_layer, length_mask):
    """The layer's SSD mixer; with a cache its state is read and written in
    place. It runs the recurrence only for a single-token step: a
    multi-token call with a cache runs the chunked scan from the cached
    state and stores the final one."""
    st = None if cache_layer is None else cache_layer["state"]
    decode = cache_layer is not None and h.shape[1] == 1
    y, new_state = SSD.ssd_apply(lp["ssm"], h, cfg, state=st, decode=decode,
                                 length_mask=length_mask)
    if st is not None:
        st.copy_(new_state)
    return y


def _attn_split(cfg: ModelConfig) -> tuple[int, int]:
    """How many ways the ambient mesh splits this config's q heads and its
    KV heads (``sharding.attention_split``)."""
    mesh = current_mesh()
    m = 1 if mesh is None else mesh.size("model")
    return attention_split(cfg.num_heads, cfg.num_kv_heads, m)


def _local_attention(p: dict, cfg: ModelConfig, mesh):
    """(params, AttnDims) of this rank's attention. Its q heads are all of
    them or a shard (read from ``w_q``'s width); where they are a shard and
    K/V whole, q head j of rank r (global head r * H_l + j) reads KV head
    (r * H_l + j) * Hkv // H, the reference's GQA grouping, and ``w_k``/
    ``w_v`` pass *f*: this rank's gradient of them is its q heads' part."""
    hd = cfg.resolved_head_dim
    heads, kv_heads = _width(p["w_q"]) // hd, _width(p["w_k"]) // hd
    kv_index = None
    if heads != cfg.num_heads and kv_heads == cfg.num_kv_heads:
        first = mesh.local_rank("model") * heads
        kv_index = tuple((first + j) * kv_heads // cfg.num_heads for j in range(heads))
        p = {**p, **{n: C.copy_to_axis(p[n], mesh) for n in ("w_k", "w_v")
                     if isinstance(p[n], torch.Tensor)}}
    return p, L.AttnDims(cfg.d_model, heads, kv_heads, hd, kv_index)


def _width(w) -> int:
    """N of a (..., K, N) weight or PlannedWeight."""
    return w.n if isinstance(w, engine.PlannedWeight) else w.shape[-1]


def _rows(w) -> int:
    """K of a (..., K, N) weight or PlannedWeight."""
    return w.k if isinstance(w, engine.PlannedWeight) else w.shape[-2]


def _vocab_lookup(table, ids):
    """``table[ids]`` from a vocab shard of the table on every rank of the
    ambient mesh's model axis: each rank takes the rows of the ids in its
    range and zeros for the rest, then they sum. Exact: every id's row
    comes from one rank and zeros from the others."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("a vocab-sharded embedding needs the mesh it was sharded over "
                         "(parallel.mesh.use_mesh)")
    Vl = table.shape[0]
    local = ids - mesh.local_rank("model") * Vl
    valid = (local >= 0) & (local < Vl)
    rows = table[local.clamp(0, Vl - 1)]
    return C.all_reduce(torch.where(valid[..., None], rows, torch.zeros_like(rows)), mesh)


def _embed_tokens(params, cfg: ModelConfig, tokens, patch_embeds=None):
    """Token embeddings (B, S, d); audio sums its codebooks' embeddings in
    codebook order, each sum rounded to the model's dtype; vlm prepends
    ``patch_embeds`` (B, P, d), cast to the model's dtype. A vocab-sharded
    table looks up across the model axis (:func:`_vocab_lookup`)."""
    embed = _gathered(params, "embed")
    sharded = embed.shape[-2] != padded_vocab(cfg)
    look = _vocab_lookup if sharded else (lambda t, i: t[i])
    if cfg.frontend == "audio_codebooks":
        x = look(embed[0], tokens[..., 0])
        for c in range(1, cfg.num_codebooks):
            x = x + look(embed[c], tokens[..., c])
        return x
    x = look(embed, tokens)
    if cfg.frontend == "vision_patches" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _gathered(params, name: str):
    """``params[name]`` whole over the ZeRO-3 axes of the ambient placement
    (``parallel.sharding.use_placement``): gathered at use."""
    placement = current_placement()
    if placement is None:
        return params[name]
    return gather_param(params[name], placement[name], current_mesh())


def _layer(x, lp, window: int, cfg: ModelConfig, positions, cache_layer=None,
           cache_index=None, length_mask=None):
    """One decoder layer: (x, its MoE load-balancing loss or None). A
    column-parallel block's input passes Megatron's *f*
    (``collectives.copy_to_axis``: its gradient summed over the model axis)
    and its row-parallel output *g* (the all-reduce)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + _ssd(lp, h, cfg, cache_layer, length_mask), None
    attn, dims = _local_attention(lp["attn"], cfg, current_mesh())
    tp_attn = dims.num_heads != cfg.num_heads    # the rank's q heads: a shard
    y, _ = L.attn_apply(attn, C.copy_to_axis(h, current_mesh()) if tp_attn else h,
                        dims, positions, cfg.rope_theta, window,
                        cache=cache_layer, cache_index=cache_index)
    if tp_attn:                                  # row-parallel w_o: partial sums
        y = C.all_reduce(y, current_mesh())
    if cfg.family == "hybrid":
        # parallel attention and SSD branches on ln1(x), their norms averaged
        ys = _ssd(lp, h, cfg, cache_layer, length_mask)
        y = 0.5 * (L.rmsnorm(y, lp["attn_norm"], cfg.norm_eps)
                   + L.rmsnorm(ys, lp["ssm_norm"], cfg.norm_eps))
    x = x + y
    h2 = h if cfg.parallel_block else L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        # the shard-rounded capacity of the layer's B*S tokens (a data-split
        # serving step's: the whole step's), as the reference's layer stack
        # serves it (the grouped plan keys embed C)
        cap = layer_capacity(cfg, MOE.capacity_rows(h2.shape[0]) * h2.shape[1])
        with trace.span("model.mlp"):
            y2, aux = MOE.moe_apply(lp["moe"], h2, cfg.experts_per_token, cfg.capacity_factor,
                                    deterministic_capacity=cap, num_experts=cfg.num_experts)
        return x + y2, aux
    if "mlp" not in lp:                           # d_ff == 0: no MLP, zeros added
        return x + torch.zeros_like(x), None
    if _rows(lp["mlp"]["mlp_down"]) != cfg.d_ff:  # row-parallel mlp_down: partial sums
        y2 = L.mlp_apply(lp["mlp"], C.copy_to_axis(h2, current_mesh()))
        y2 = C.all_reduce(y2, current_mesh())
    else:
        y2 = L.mlp_apply(lp["mlp"], h2)
    return x + y2, None


def forward(params, cfg: ModelConfig, tokens, *, patch_embeds=None, cache=None,
            cache_index=None, fcfg: FalconConfig | None = None, logits_mode: str = "none",
            length_mask=None):
    """Run the decoder stack on ``tokens`` (B, S), or (B, S, CB) for audio.

    logits_mode: "none" (return hidden), "last" (logits of the final
    position), "all". With a ``cache`` the new K/V (and SSD state) are
    written into it in place at ``cache_index``. ``length_mask`` (B, S): 1
    on real positions, 0 on right pad; it makes a bucketed (right-padded)
    prefill exact for the recurrent state. ``patch_embeds`` (B, P, d), vlm
    only: the image prefix, at positions 0..P-1 (the text follows, so a
    decode step after it runs at ``cache_index = P + S``). Returns (out,
    cache). FalconGEMM policy is the ambient config, else this model's
    ``falcon_config_for``; ``fcfg`` is a deprecated per-call override.
    """
    with engine.config_scope(fcfg, "forward", lambda: falcon_config_for(cfg)):
        out, cache, _ = _forward(params, cfg, tokens, patch_embeds=patch_embeds, cache=cache,
                                 cache_index=cache_index, logits_mode=logits_mode,
                                 length_mask=length_mask)
    return out, cache


def _forward(params, cfg: ModelConfig, tokens, *, patch_embeds=None, cache=None,
             cache_index=None, logits_mode: str = "none", length_mask=None):
    """:func:`forward`, also returning the MoE layers' summed load-balancing
    loss (None for a model without MoE layers): (out, cache, aux).

    Under autograd the stacked leaves are unbound once, and without a cache
    each layer runs under ``torch.utils.checkpoint`` when ``cfg.remat`` is
    set (recomputed in backward, as the reference's ``jax.checkpoint``,
    under ``cfg.remat_policy``: ``layers.remat``)."""
    _check_family(cfg)
    with engine.config_scope(None, "forward", lambda: falcon_config_for(cfg)):
        with trace.span("model.embed"):
            x = _embed_tokens(params, cfg, tokens, patch_embeds)   # (B, S, d)
        B, S = x.shape[:2]
        steps = torch.arange(S, device=x.device)
        if cache is None:
            positions = steps.expand(B, S)
        elif isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
            positions = cache_index[:, None] + steps            # per-row offsets
        else:
            positions = (int(cache_index) + steps).expand(B, S)
        windows = cfg.layer_windows()
        mesh, placement = current_mesh(), current_placement()
        # the ZeRO-3 shards of a layer are gathered inside its (remat)
        # function, so a recompute gathers again and no whole weight is kept
        lpl = None if placement is None else unstack_placement(placement["layers"])
        grad = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in tree_leaves(params["layers"]))
        per_layer = (_unbind_layers(params["layers"], len(windows)) if grad else
                     [layer_params(params["layers"], i) for i in range(len(windows))])
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        aux = None
        for i, window in enumerate(windows):
            cl = None if cache is None else {name: c[i] for name, c in cache.items()}
            layer = dict(window=window, cfg=cfg, positions=positions,
                         cache_layer=cl, cache_index=cache_index, length_mask=length_mask)

            def run(x_, lp=per_layer[i], kw=layer):
                return _layer(x_, gather_tree(lp, lpl, mesh), **kw)

            x, a = L.remat(run, x, policy=cfg.remat_policy) if remat else run(x)
            if a is not None:
                aux = a if aux is None else aux + a
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if logits_mode == "none":
            return x, cache, aux
        if logits_mode == "last":
            x = x[:, -1:]
        return compute_logits(params, cfg, x), cache, aux


def compute_logits(params, cfg: ModelConfig, x, fcfg: FalconConfig | None = None):
    """LM head (tied to the embedding unless ``lm_head`` exists), with the
    padded-vocab columns masked to -1e30. Audio runs one head per codebook,
    each its own dense call as in the reference, stacked to (B, S, CB, Vp).
    A vocab-sharded head's input passes *f* and its logits are
    all-gathered over the model axis (backward: this rank's slice, since
    every rank of the axis computes the same loss from them). ``fcfg`` is a
    deprecated per-call override."""
    with engine.config_scope(fcfg, "compute_logits", lambda: falcon_config_for(cfg)), \
            trace.span("model.lm_head"):
        Vp = padded_vocab(cfg)
        if cfg.frontend == "audio_codebooks":
            head = _gathered(params, "lm_head")
            if _width(head) != Vp:
                x = C.copy_to_axis(x, current_mesh())
            logits = torch.stack([engine.dense(x, head[c])
                                  for c in range(cfg.num_codebooks)], dim=2)
        else:
            w = (_gathered(params, "lm_head") if not cfg.tie_embeddings
                 else _gathered(params, "embed").T)
            if _width(w) != Vp:
                x = C.copy_to_axis(x, current_mesh())
            logits = engine.dense(x, w)
        if logits.shape[-1] != Vp:
            logits = C.all_gather(logits, current_mesh(), dim=-1, backward="slice")
        if Vp == cfg.vocab_size:
            return logits
        pad_mask = torch.arange(Vp, device=x.device) < cfg.vocab_size
        return torch.where(pad_mask, logits, -1e30)


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy: never materialize (B, S, V) for big vocabs)
# ---------------------------------------------------------------------------

def _chunk_loss(params, cfg: ModelConfig, h, lab):
    """Summed cross-entropy of one chunk: f32 logits, logsumexp less the gold
    logit (labels (B, c) or, audio, (B, c, CB))."""
    logits = compute_logits(params, cfg, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_xent(params, cfg: ModelConfig, hidden, labels,
                 fcfg: FalconConfig | None = None, chunk: int = 512):
    """hidden (B, S, d), labels (B, S[, CB]) -> mean cross-entropy (f32).

    The sequence runs in chunks of at most ``chunk`` positions (the largest
    divisor of S not above it); under autograd each chunk's logits are
    recomputed in backward (``torch.utils.checkpoint``), so no (B, chunk,
    V) logits are stored for it. ``fcfg`` is a deprecated per-call
    override."""
    with engine.config_scope(fcfg, "chunked_xent", lambda: falcon_config_for(cfg)):
        S = hidden.shape[1]
        chunk = min(chunk, S)
        while S % chunk:
            chunk -= 1
        grad = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in [hidden, *tree_leaves(params)])
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s in range(0, S, chunk):
            h, lab = hidden[:, s:s + chunk], labels[:, s:s + chunk]
            part = (L.remat(_chunk_loss, params, cfg, h, lab) if grad
                    else _chunk_loss(params, cfg, h, lab))
            total = total + part
        return total / labels.numel()


def lm_loss(params, cfg: ModelConfig, batch: dict, fcfg: FalconConfig | None = None):
    """batch: {'tokens', 'labels'[, 'patch_embeds']} -> (loss, metrics).

    The loss is the chunked cross-entropy plus 0.01 times the MoE layers'
    summed load-balancing loss; a vlm's covers its text positions only.
    ``metrics`` holds ``xent`` and ``aux`` (f32 scalars). ``fcfg`` is a
    deprecated per-call override."""
    with engine.config_scope(fcfg, "lm_loss", lambda: falcon_config_for(cfg)):
        hidden, _, aux = _forward(params, cfg, batch["tokens"],
                                  patch_embeds=batch.get("patch_embeds"), logits_mode="none")
        labels = batch["labels"]
        if cfg.frontend == "vision_patches":
            hidden = hidden[:, -labels.shape[1]:]   # the loss on the text positions
        xent = chunked_xent(params, cfg, hidden, labels)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=xent.device)
        loss = xent + 0.01 * aux
        return loss, {"xent": xent, "aux": aux}
