"""Workload registry: one config -> its contraction set -> the warm grid.

Every planned contraction of a :class:`ModelConfig` (attention projections,
the attention einsums, the swiglu MLP or, for MoE, the grouped expert FFN,
the SSD mixer's projections and its chunked-scan and decode contractions,
the padded lm head) is listed once here as a symbolic
:class:`ContractionSpec`, and resolved to concrete plan shapes per (batch,
seq) call context by :func:`resolve_contractions`, which
``core.engine.warm_buckets`` (and so ``ServeEngine.warm``) consumes. The
hybrid family emits its attention and its SSD specs both;
``ContractionSpec.layers`` can pin a spec to some layers of a heterogeneous
stack. The tune CLI warms the plan cache over :func:`warm_shapes`: the
dense projection pairs of a workload swept over ``WARM_TOKENS``, plus
square operators. The MoE expert capacity has its one definition here
(:func:`moe_capacity`): the grouped plan keys embed it, so the layer and
the resolver must agree. ``mesh_shape`` scales the symbols the reference
scales (the expert group over "model" shards, the MoE capacity's tokens
over "data" shards); ``resolve_contractions(..., local=True)`` then gives
the shapes each rank of the port's explicit tensor parallelism contracts.

The paper's three LLM serving workloads (§IV-B: DeepSeek-R1, Qwen3.5,
HunyuanVideo projections) are registry entries too, addressable by name,
so ``contraction_set("deepseek_r1")`` and a model config give grids of the
same form. ``train=True`` adds each forward contraction's two backward ones
(``dA``, ``dB``: the planned autograd cores' gradient contractions).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import FAMILIES

__all__ = [
    "ContractionSpec", "Contraction", "contraction_set", "resolve_contractions",
    "dense_projection_shapes", "grouped_moe_shapes", "paper_workloads",
    "paper_projection_shapes", "warm_shapes", "shape_token", "moe_capacity",
    "layer_capacity", "WARM_TOKENS", "WARM_SQUARE", "F32_KINDS",
]

# Paper §IV-B LLM projection (K, N) pairs. Data only — addressed through
# contraction_set(<name>) / paper_projection_shapes(<name>).
_PAPER_PROJECTIONS = {
    "deepseek_r1": [(7168, 18432), (18432, 7168), (7168, 2048), (2048, 7168),
                    (7168, 4096), (4096, 7168), (1536, 7168), (7168, 1536),
                    (7168, 9216), (9216, 7168), (7168, 7168)],
    "qwen3_5": [(5120, 25600), (25600, 5120), (5120, 5120), (5120, 640),
                (640, 5120), (5120, 13824), (13824, 5120)],
    "hunyuan_video": [(3072, 12288), (12288, 3072), (3072, 3072),
                      (3072, 9216), (9216, 3072), (3072, 6144)],
}

# Tokens-per-call (batch x seq) grid and square operator sizes used to
# pre-warm the plan cache for serving.
WARM_TOKENS = [128, 512, 2048, 8192]
WARM_SQUARE = [512, 1024, 2048, 4096, 8192, 16384]

# The flash-attention query chunk (models.layers.flash_attention): no-cache
# attention over sequences longer than this runs in 512-query chunks.
_FLASH_Q_CHUNK = 512
# lm-head cross-entropy chunk cap of the reference's training loss.
_XENT_CHUNK = 512
# Contraction kinds that run in float32 whatever the model's dtype: the SSD
# scan and decode step cast their operands up (``models.ssd``), so their
# plans are keyed on float32.
F32_KINDS = ("ssd_scan", "ssd_decode")


@dataclasses.dataclass(frozen=True)
class ContractionSpec:
    """One planned contraction class, with symbolic M/K/N/group dims.

    Dims are ints (from the config) or symbol strings bound per call:
    ``tokens`` (batch * sequence, the projection rows), ``logit_tokens``
    (lm-head rows), ``attn_q`` / ``attn_kv`` / ``head_dim`` (attention
    einsums), ``capacity`` (the per-expert MoE capacity C,
    :func:`moe_capacity`), ``ssd_chunk`` / ``ssd_state`` / ``ssd_head_dim``
    (the SSD scan), ``one`` (a literal 1: the SSD decode readout's rows),
    and the groups ``attn_groups`` (batch * heads), ``experts`` (E),
    ``ssd_groups`` (batch * n_chunks * SSD heads) and ``ssd_decode_groups``
    (batch * SSD heads).
    """
    kind: str              # dense | grouped_moe | attention | ssd_scan | ssd_decode
    role: str              # e.g. "attn.w_q", "moe.down", "ssd.scores"
    m: int | str
    k: int | str
    n: int | str
    group: int | str = 1          # 1 => plain 2-D contraction
    shared_b: bool = False
    # B operand is a static model weight => precombinable offline
    # (falcon.precombine_params) and eligible for the int8 quant tier.
    weight_static: bool = True
    # () => every layer with this block type; a tuple => those layer indices
    # only (a heterogeneous stack)
    layers: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Contraction:
    """A concrete contraction — what the plan cache is keyed on."""
    kind: str
    role: str
    m: int
    k: int
    n: int
    group: int = 1
    shared_b: bool = False
    weight_static: bool = True

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.m, self.k, self.n)

    def key_shape(self) -> str:
        """The shape token as it appears inside a plan-cache key."""
        if self.group == 1:
            return f"{self.m}x{self.k}x{self.n}"
        return f"g{self.group}x{self.m}x{self.k}x{self.n}|sb={int(self.shared_b)}"


def moe_capacity(tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float, shard_round: bool = False) -> int:
    """Per-expert token capacity ``C = max(ceil(T·k/E·cf), 8)``.

    The one definition of MoE capacity, shared by ``models.moe.moe_apply``,
    the layer stack (``models.model``, which passes ``shard_round=True`` to
    round capacities above 256 up to a multiple of 256, as the reference's
    shardable layer does) and the registry resolver here (warm-bucket
    pre-planning), both through :func:`layer_capacity`. The grouped
    plan-cache keys embed C, so these sites must agree bit for bit.
    """
    c = max(math.ceil(tokens * top_k / num_experts * capacity_factor), 8)
    if shard_round and c > 256:
        c = -(-c // 256) * 256
    return c


def _resolve_arch(arch):
    """str -> ModelConfig via the configs registry; pass configs through."""
    if isinstance(arch, str):
        from repro_torch.configs import registry
        return registry.get_config(arch)
    return arch


def _mesh_factors(mesh_shape) -> tuple[int, int]:
    """-> (data shards, model shards). Accepts the engine's axis-name dict
    (``{"data": .., "model": .., "pod": ..}``) or a plain (data, model)
    tuple; None => single device."""
    if not mesh_shape:
        return 1, 1
    if isinstance(mesh_shape, dict):
        nd = int(mesh_shape.get("data", 1)) * int(mesh_shape.get("pod", 1) or 1)
        return max(nd, 1), int(mesh_shape.get("model", 1)) or 1
    nd = int(mesh_shape[0]) or 1
    nm = int(mesh_shape[1]) if len(mesh_shape) > 1 else 1
    return max(nd, 1), max(nm, 1)


def paper_workloads() -> list[str]:
    """The paper's §IV-B LLM workload names (addressable by contraction_set)."""
    return list(_PAPER_PROJECTIONS)


def paper_projection_shapes(workload: str) -> list[tuple[int, int]]:
    """(K, N) projection pairs of one paper workload, via the registry."""
    return [(s.k, s.n) for s in contraction_set(workload)]


def _paper_specs(workload: str) -> list[ContractionSpec]:
    return [ContractionSpec("dense", f"{workload}.proj{i}", "tokens", k, n)
            for i, (k, n) in enumerate(_PAPER_PROJECTIONS[workload])]


def _model_specs(cfg) -> list[ContractionSpec]:
    """Forward contraction specs of one ModelConfig, block by block as
    ``models.model._layer`` dispatches them: attention for every family but
    the pure SSM one, MoE's grouped expert FFN in place of the dense MLP
    (its router is a plain f32 matmul, not planned), no MLP for the pure
    SSM family, the SSD block for the SSM and hybrid ones."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; the registry lists {FAMILIES}")
    d, fam = cfg.d_model, cfg.family
    specs: list[ContractionSpec] = []
    heads = cfg.num_heads
    if heads and fam != "ssm":
        hd = cfg.resolved_head_dim
        kv = cfg.num_kv_heads or heads
        specs += [
            ContractionSpec("dense", "attn.w_q", "tokens", d, heads * hd),
            ContractionSpec("dense", "attn.w_k", "tokens", d, kv * hd),
            ContractionSpec("dense", "attn.w_v", "tokens", d, kv * hd),
            ContractionSpec("dense", "attn.w_o", "tokens", heads * hd, d),
            # QK^T and AV einsums: grouped over B*H heads (GQA K/V are
            # repeated up to H before the einsum), activation x activation.
            ContractionSpec("attention", "attn.qk", "attn_q", "head_dim", "attn_kv",
                            group="attn_groups", weight_static=False),
            ContractionSpec("attention", "attn.av", "attn_q", "attn_kv", "head_dim",
                            group="attn_groups", weight_static=False),
        ]
    ff = cfg.d_ff
    if ff and fam not in ("ssm", "moe"):
        if cfg.mlp_type == "swiglu":
            specs.append(ContractionSpec("dense", "mlp.gate", "tokens", d, ff))
        specs += [ContractionSpec("dense", "mlp.up", "tokens", d, ff),
                  ContractionSpec("dense", "mlp.down", "tokens", ff, d)]
    if fam == "moe":
        specs += [ContractionSpec("grouped_moe", f"moe.{role}", "capacity", k, n,
                                  group="experts")
                  for role, k, n in (("gate", d, ff), ("up", d, ff), ("down", ff, d))]
    if cfg.ssm_heads and fam in ("ssm", "hybrid"):
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        d_in_proj = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
        act = dict(weight_static=False)
        specs += [
            ContractionSpec("dense", "ssm.in_proj", "tokens", d, d_in_proj),
            ContractionSpec("dense", "ssm.out_proj", "tokens", d_inner, d),
            # chunked-scan contractions (models.ssd.ssd_scan), grouped over
            # B * n_chunks * H; the decays are folded into the operands
            # elementwise, so each einsum is one 2-operand grouped product
            ContractionSpec("ssd_scan", "ssd.scores", "ssd_chunk", "ssd_state", "ssd_chunk",
                            group="ssd_groups", **act),
            ContractionSpec("ssd_scan", "ssd.y_diag", "ssd_chunk", "ssd_chunk",
                            "ssd_head_dim", group="ssd_groups", **act),
            ContractionSpec("ssd_scan", "ssd.states", "ssd_state", "ssd_chunk",
                            "ssd_head_dim", group="ssd_groups", **act),
            ContractionSpec("ssd_scan", "ssd.y_off", "ssd_chunk", "ssd_state",
                            "ssd_head_dim", group="ssd_groups", **act),
            # the single-token recurrence (models.ssd.ssd_decode_step)
            ContractionSpec("ssd_decode", "ssd.state_update", "ssd_state", "one",
                            "ssd_head_dim", group="ssd_decode_groups", **act),
            ContractionSpec("ssd_decode", "ssd.readout", "one", "ssd_state",
                            "ssd_head_dim", group="ssd_decode_groups", **act),
        ]
    # the lm head: audio runs one per codebook, each of this same (d, Vp) shape
    vp = -(-cfg.vocab_size // 256) * 256   # padded vocab (models.model.padded_vocab)
    specs.append(ContractionSpec("dense", "lm_head", "logit_tokens", d, vp))
    return specs


def contraction_set(arch, *, train: bool = False, mesh_shape=None,
                    quantize: bool = False) -> list[ContractionSpec]:
    """Every planned contraction ``arch`` runs, as symbolic specs.

    ``arch`` is a :class:`ModelConfig`, a registry arch id
    (``"granite_3_2b"``) or a paper workload name (``"deepseek_r1"``).
    ``train=True`` appends the two backward specs of each forward one
    (``role.dA`` / ``role.dB``). ``mesh_shape=(data, model)`` scales the
    ``experts`` group to the per-shard expert count (where the experts
    divide the model axis). ``quantize=True`` keeps the contractions
    the int8 tier can serve (a static-weight B operand: the dense
    projections and the expert FFN).
    """
    if isinstance(arch, str) and arch in _PAPER_PROJECTIONS:
        specs = _paper_specs(arch)
    else:
        specs = _model_specs(_resolve_arch(arch))
    if mesh_shape:
        _, nm = _mesh_factors(mesh_shape)

        def _scale(s):
            if s.group == "experts":
                E = _resolve_arch(arch).num_experts
                return dataclasses.replace(
                    s, group=E // nm if nm > 1 and E % nm == 0 else E)
            return s
        specs = [_scale(s) for s in specs]
    if train:
        specs = specs + [b for s in specs for b in _backward_specs(s)]
    if quantize:
        specs = [s for s in specs
                 if s.weight_static and s.kind in ("dense", "grouped_moe")]
    return specs


def _backward_specs(s: ContractionSpec) -> list[ContractionSpec]:
    """Symbolic backward contractions of one forward spec.

    Dense ``(M, K, N)`` -> dA ``(M, N, K)``, dB ``(K, M, N)``
    (``core.decision.backward_shapes``); grouped keeps the group: dA ``(G,
    M, N, K)``, dB ``(G, K, M, N)``, as the planned autograd cores of
    ``core.engine`` run them. A shared-B grouped dB collapses to a dense
    ``(K, G*M, N)``; no model spec is shared-B, so that case is resolved
    concretely in :func:`resolve_contractions` only.
    """
    return [
        dataclasses.replace(s, role=s.role + ".dA", m=s.m, k=s.n, n=s.k,
                            weight_static=False),
        dataclasses.replace(s, role=s.role + ".dB", m=s.k, k=s.m, n=s.n,
                            weight_static=False),
    ]


def _shape_env(cfg, batch: int, seq: int, *, kv_len=None, decode=False,
               mesh_shape=None, spec_verify=False) -> dict:
    """Symbol values for one (batch, seq) call context.

    ``kv_len`` set => serving against a KV cache of that length (attention
    keys span the cache, the lm head sees one row per sequence);
    ``decode=True`` => a single-token step (seq is the number of new tokens,
    normally 1). ``spec_verify=True`` => a speculative verify step: seq is
    γ+1 draft-scoring rows and the lm head runs on every one of them
    (``logit_tokens = batch * seq`` instead of ``batch``). ``mesh_shape``:
    the MoE capacity is the layer's at the tokens of one "data" shard.
    """
    # a vlm sequence counts its image patches beside the text; a decode step
    # carries none (the reference counts them there too)
    patches = cfg.num_patches if cfg.frontend == "vision_patches" and not decode else 0
    S = seq + patches
    env: dict = {"one": 1, "tokens": batch * S, "batch": batch, "seq": S}
    if decode:
        env["attn_q"], env["attn_kv"] = 1, (kv_len or S)
    elif kv_len is not None:
        env["attn_q"], env["attn_kv"] = S, kv_len
    else:
        flash = S > _FLASH_Q_CHUNK and S % _FLASH_Q_CHUNK == 0
        env["attn_q"] = _FLASH_Q_CHUNK if flash else S
        env["attn_kv"] = S
    env["attn_groups"] = batch * cfg.num_heads
    env["head_dim"] = cfg.resolved_head_dim
    if kv_len is not None or decode:
        env["logit_tokens"] = batch * S if spec_verify else batch
    else:
        cx = min(_XENT_CHUNK, seq)
        while cx > 1 and seq % cx:
            cx -= 1
        env["logit_tokens"] = batch * cx
    if getattr(cfg, "num_experts", 0):
        nd, _ = _mesh_factors(mesh_shape)
        env["capacity"] = layer_capacity(cfg, max(-(-(batch * S) // nd), 1))
        env["experts"] = cfg.num_experts
    if getattr(cfg, "ssm_heads", 0):
        n_chunks = max(1, -(-S // cfg.ssm_chunk))
        env.update(ssd_chunk=cfg.ssm_chunk, ssd_state=cfg.ssm_state,
                   ssd_head_dim=cfg.ssm_head_dim, ssd_groups=batch * n_chunks * cfg.ssm_heads,
                   ssd_decode_groups=batch * cfg.ssm_heads)
    return env


def layer_capacity(cfg, tokens: int) -> int:
    """The capacity an MoE config's layer stack serves ``tokens`` rows with
    (:func:`moe_capacity`, shard-rounded): ``models.model``, the resolver
    here and the tools that size a layer's expert calls all read it."""
    return moe_capacity(tokens, cfg.experts_per_token or 1, cfg.num_experts,
                        cfg.capacity_factor, shard_round=True)


def resolve_contractions(arch, batch: int, seq: int, *, train: bool = False,
                         mesh_shape=None, kv_len=None, decode: bool = False,
                         spec_verify: bool = False, local: bool = False) -> list[Contraction]:
    """Concrete contraction inventory for one (batch, seq) call context.

    Returns deduplicated :class:`Contraction` entries whose ``key_shape()``
    tokens are exactly what ``core.plan_cache`` keys embed. ``train=True``
    puts both backward contractions after each forward one (a shared-B
    grouped dB as its dense ``(K, G*M, N)`` form). ``kv_len``, ``decode``
    and ``spec_verify`` are as in :func:`_shape_env`; a decode context keeps
    the SSD recurrence and drops the scan, any other keeps the scan and
    drops the recurrence. ``mesh_shape`` scales the expert group and the
    capacity as the reference does (:func:`contraction_set`,
    :func:`_shape_env`): the other shapes stay global. ``local=True`` (a
    port extension) gives instead the shapes each rank of ``mesh_shape``
    contracts under the port's explicit tensor parallelism
    (:func:`_localize`), deduplicated as such: two leaves of one global
    shape (granite's ``w_q`` and ``w_o``) can shard on different dims.
    There ``batch`` is the global batch, split over the data axis (under
    the config's ``parallel_style="fsdp_only"``: over data x model, with
    no tensor parallelism, every weight gathered whole); a serving step
    pads its rows to the local bucket, ``ceil(batch / data)``
    (``parallel.mesh.data_rows``), and its MoE capacity stays the whole
    batch's (each data rank routes as one device would); a train step's
    batch must split evenly, and each data rank routes its own tokens. So with
    ``train=True`` each rank's forward, dA and dB shapes under TP, FSDP
    (a ZeRO-3 weight is gathered to its TP shard before use) and
    ``fsdp_only``.
    """
    paper = isinstance(arch, str) and arch in _PAPER_PROJECTIONS
    whole = batch
    if local and not paper:
        from repro_torch.parallel.mesh import data_rows
        nd, nm = _mesh_factors(mesh_shape)
        if getattr(_resolve_arch(arch), "parallel_style", "tp") == "fsdp_only":
            nd, nm = nd * nm, 1
        if train and batch % nd:
            raise ValueError(f"resolve_contractions: a batch of {batch} does not split over "
                             f"{nd} ranks")
        batch = data_rows(batch, nd)[0]
        mesh_shape = {"data": 1, "model": nm}
    specs = contraction_set(arch, mesh_shape=mesh_shape)
    env = {"tokens": batch * seq} if paper else _shape_env(
        _resolve_arch(arch), batch, seq, kv_len=kv_len, decode=decode,
        mesh_shape=mesh_shape, spec_verify=spec_verify)
    if local and not train and "capacity" in env:
        # a serving step's data ranks route as one device routes the whole
        # batch (models.moe.route_over_data): the capacity is the batch's
        env["capacity"] = layer_capacity(_resolve_arch(arch), whole * env["seq"])

    def val(x):
        return env[x] if isinstance(x, str) else x

    out: list[Contraction] = []
    seen: set = set()

    def emit(c: Contraction):
        if (c.key_shape(), c.kind) not in seen:
            seen.add((c.key_shape(), c.kind))
            out.append(c)

    for s in specs:
        if s.kind == ("ssd_scan" if decode else "ssd_decode"):
            continue
        c = Contraction(s.kind, s.role, val(s.m), val(s.k), val(s.n), group=val(s.group),
                        shared_b=s.shared_b, weight_static=s.weight_static)
        if local:
            c = _localize(c, _resolve_arch(arch), mesh_shape)
        emit(c)
        if train:
            emit(Contraction(c.kind, c.role + ".dA", c.m, c.n, c.k, group=c.group,
                             shared_b=c.shared_b, weight_static=False))
            if c.group != 1 and c.shared_b:
                emit(Contraction("dense", c.role + ".dB", c.k, c.group * c.m, c.n,
                                 weight_static=False))
            else:
                emit(Contraction(c.kind, c.role + ".dB", c.k, c.m, c.n, group=c.group,
                                 shared_b=c.shared_b, weight_static=False))
    return out


def dense_projection_shapes(arch) -> list[tuple[int, int]]:
    """Deduplicated dense-projection ``(K, N)`` pairs of one arch."""
    out: list[tuple[int, int]] = []
    for s in contraction_set(arch):
        if s.kind == "dense" and (s.k, s.n) not in out:
            out.append((s.k, s.n))
    return out


def grouped_moe_shapes(arch, m_tokens: int,
                       mesh_shape=None) -> list[tuple[int, int, int, int]]:
    """Grouped MoE expert shapes ``(E, C, K, N)`` at ``m_tokens`` rows,
    deduplicated, C shard-rounded (the grouped plan-cache keys embed C).
    ``mesh_shape`` scales them as the reference's does: tokens over data
    shards, experts over model shards (where they divide), and C then taken
    at the per-shard expert count, as the reference computes it."""
    cfg = _resolve_arch(arch)
    E = cfg.num_experts
    if not E:
        return []
    specs = [s for s in contraction_set(cfg, mesh_shape=mesh_shape)
             if s.kind == "grouped_moe"]
    nd, nm = _mesh_factors(mesh_shape)
    if nm > 1 and E % nm == 0:
        E //= nm
    mt = max(-(-m_tokens // nd), 1)
    C = moe_capacity(mt, cfg.experts_per_token or 1, E, cfg.capacity_factor,
                     shard_round=True)
    out: list[tuple[int, int, int, int]] = []
    for s in specs:
        g = s.group if isinstance(s.group, int) else E
        shape = (g, C, s.k, s.n)
        if shape not in out:
            out.append(shape)
    return out


def _localize(c: Contraction, cfg, mesh_shape) -> Contraction:
    """The shape of ``c`` on one rank of ``mesh_shape`` under the port's
    explicit tensor parallelism: a column-parallel projection (``w_q``,
    ``w_k``, ``w_v``, ``mlp_gate``, ``mlp_up``, the vocab-sharded LM head)
    contracts N / model, a row-parallel one (``w_o``, ``mlp_down``) K /
    model, the attention einsums run over the local heads' groups. An
    attention block shards only where both head counts divide the model
    axis, the MLP only where d_ff does; the SSD mixer stays whole, and the
    expert group and capacity are already the shard's. The reference
    instead prices every leaf at full K and N / model
    (``falcon_config_for``'s ``shards``): its GSPMD traces global shapes."""
    _, nm = _mesh_factors(mesh_shape)
    if nm <= 1:
        return c
    attn = cfg.num_heads % nm == 0 and cfg.num_kv_heads % nm == 0
    mlp = cfg.d_ff % nm == 0
    col = {"attn.w_q": attn, "attn.w_k": attn, "attn.w_v": attn, "mlp.gate": mlp,
           "mlp.up": mlp, "lm_head": (-(-cfg.vocab_size // 256) * 256) % nm == 0}
    row = {"attn.w_o": attn, "mlp.down": mlp}
    if col.get(c.role):
        return dataclasses.replace(c, n=c.n // nm)
    if row.get(c.role):
        return dataclasses.replace(c, k=c.k // nm)
    if c.kind == "attention" and attn:
        return dataclasses.replace(c, group=c.group // nm)
    return c


def warm_shapes(workload: str = "deepseek_r1") -> list[tuple[int, int, int]]:
    """(M, K, N) grid the tune CLI warms the plan cache with: the dense
    projection pairs of ``workload`` (a paper workload or a registry arch
    id) over the WARM_TOKENS grid, plus square operator sizes."""
    pairs = [(s.k, s.n) for s in contraction_set(workload) if s.kind == "dense"
             and isinstance(s.k, int) and isinstance(s.n, int)]
    out = [(m, k, n) for m in WARM_TOKENS for k, n in pairs]
    out += [(s, s, s) for s in WARM_SQUARE]
    return out


def shape_token(plan_key: str) -> str:
    """Extract the shape token (``MxKxN`` / ``gGxMxKxN|sb=b``) of a plan key,
    following ``core.plan_cache.plan_key``'s layout: part 2 is the shape,
    and a grouped shape carries its ``sb=`` flag as the next part."""
    parts = plan_key.split("|")
    tok = parts[2]
    if tok.startswith("g") and len(parts) > 3 and parts[3].startswith("sb="):
        tok += "|" + parts[3]
    return tok
