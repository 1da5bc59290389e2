"""Core transformer layers (functional, dict params, FalconGEMM-backed).

Every dense projection routes through ``engine.dense`` and the attention
contractions through ``engine.einsum``, so the paper's technique is the
backend of the whole decoder. Dispatch policy is the context-scoped config
(``repro_torch.api.use``). Casts sit where the reference package puts them,
so the two agree in float32 up to summation order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import engine
from repro_torch.parallel.sharding import ambient_state, use_ambient_state

# ---------------------------------------------------------------------------
# Param helpers
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape: tuple[int, ...], scale, dtype,
                device, rows: int = 1) -> torch.Tensor:
    """``scale(x)`` of standard normal ``x`` of ``shape``, in ``dtype``:
    drawn in float32 ``rows`` leading indices at a time into a preallocated
    tensor, so the float32 draw of a whole stacked leaf (or embedding) never
    exists. A 4-D leaf (layers, experts, d_in, d_out) is drawn one (layer,
    expert) slice at a time: one layer of kimi_k2_1t's expert stack would
    be a 22.5 GB float32 transient, one expert is 58.7 MB. On the ``meta``
    device (shapes only) nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out          # shapes only: nothing to draw
    parts = (out[i, j] for i in range(shape[0]) for j in range(shape[1])) \
        if len(shape) == 4 else (out[i:i + rows] for i in range(0, shape[0], rows))
    for part in parts:
        part.copy_(scale(torch.randn(part.shape, generator=gen, dtype=torch.float32,
                                     device=device)))
    return out


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/d_in) weights of ``shape`` = (..., d_in, d_out); a stacked
    leaf (L, d_in, d_out) is drawn one layer slice at a time, a stack of
    experts (L, E, d_in, d_out) one expert at a time."""
    root = math.sqrt(shape[-2])
    return normal_init(gen, shape, lambda w: w / root, dtype, device,
                       rows=shape[0] if len(shape) == 2 else 1)


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    nothing inside is stored for backward, which recomputes it. The
    recomputation runs under the FalconGEMM config, the mesh, the parallel
    style and the placement ambient now (``sharding.ambient_state``), since
    backward runs outside the caller's scopes, on the card on another
    thread."""
    cfg = engine.current_config()
    state = ambient_state()

    def run(*a):
        with engine.use(cfg), use_ambient_state(state):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` rounded where the reference's ``jax.nn.silu``
    rounds: its sigmoid is ``1 / (1 + exp(-x))`` with each primitive
    rounded to ``x``'s dtype, then the product. ``F.silu`` rounds once,
    which moves 40% of bf16 values by an ulp; mamba2's stack amplifies that
    to 4x the reference's own bf16 rounding error at 4 layers
    (``tests/test_torch_ssm.py::test_bf16_rounding_matches_reference``)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) -> rotated x."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window, chunked over queries)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _mask(qpos, kpos, window: int):
    """Causal + optional sliding-window mask over (..., Sq, Sk)."""
    m = kpos[..., None, :] <= qpos[..., :, None]
    if window > 0:
        m = m & (kpos[..., None, :] > qpos[..., :, None] - window)
    return m


def attention_scores(q, k, v, qpos, kpos, window: int, kv_valid=None,
                     ragged: bool = False):
    """Direct attention. q: (B,Sq,H,hd) k,v: (B,Sk,Hkv,hd) -> (B,Sq,H,hd).

    GQA repeats K/V up to H heads. ``ragged=True`` builds the mask per batch
    row (positions differ across the batch); the uniform path keeps one
    (Sq, Sk) mask. The two contractions go through the planned einsum.
    """
    hd = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    logits = engine.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    if ragged:
        m = _mask(qpos, kpos, window)                       # (B, Sq, Sk)
        if kv_valid is not None:
            m = m & kv_valid[:, None, :]
        m = m[:, None]
    else:
        m = _mask(qpos[0], kpos[0], window)                 # (Sq, Sk)
        if kv_valid is not None:
            m = m & kv_valid[0][None, :]
        m = m[None, None]
    logits = torch.where(m, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)            # softmax in f32
    return engine.einsum("bhqk,bkhd->bqhd", p, v)


def flash_attention(q, k, v, qpos, kpos, window: int, kv_valid=None,
                    q_chunk: int = 512, ragged: bool = False):
    """Memory-bounded attention: a loop over query chunks keeps the score
    tensor at (B, H, q_chunk, Sk). Under autograd each chunk is recomputed
    in backward (``torch.utils.checkpoint``), so no chunk's scores are
    stored for it either, as the reference's ``jax.checkpoint`` does."""
    Sq = q.shape[1]
    if Sq <= q_chunk:
        return attention_scores(q, k, v, qpos, kpos, window, kv_valid=kv_valid,
                                ragged=ragged)
    if Sq % q_chunk:
        raise ValueError(f"flash_attention: {Sq} queries are not a multiple "
                         f"of the chunk {q_chunk}")

    def chunk_attn(qi, pi, kk, vv):
        return attention_scores(qi, kk, vv, pi, kpos, window, kv_valid=kv_valid,
                                ragged=ragged)

    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for s in range(0, Sq, q_chunk):
        args = (q[:, s:s + q_chunk], qpos[:, s:s + q_chunk], k, v)
        outs.append(remat(chunk_attn, *args) if grad else chunk_attn(*args))
    return torch.cat(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int


def attn_apply(p: dict, x: torch.Tensor, dims: AttnDims, positions, theta: float,
               window: int, cache: dict | None = None, cache_index=None):
    """Attention with optional KV cache.

    prefill/train: cache=None -> self-attention over x.
    with cache={'k','v'} (B, S_max, Hkv, hd): x (B, S, d) is written at
    ``cache_index`` and attends to everything written so far. The cache is
    updated IN PLACE (the returned cache is the same dict).

    ``cache_index`` is an int (all rows at the same offset — the one-shot
    serve path) or a (B,) tensor of per-row offsets (K/V writes, validity
    and the causal mask are then applied per row).
    """
    B, S, _ = x.shape
    H, Hkv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = engine.dense(x, p["w_q"]).reshape(B, S, H, hd)
    k = engine.dense(x, p["w_k"]).reshape(B, S, Hkv, hd)
    v = engine.dense(x, p["w_v"]).reshape(B, S, Hkv, hd)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    if cache is None:
        out = flash_attention(q, k, v, positions, positions, window)
    else:
        ck, cv = cache["k"], cache["v"]
        S_max = ck.shape[1]
        kpos = torch.arange(S_max, device=x.device).expand(B, S_max)
        ragged = isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1
        if ragged:
            rows = torch.arange(B, device=x.device)[:, None]
            cols = cache_index[:, None] + torch.arange(S, device=x.device)
            ck[rows, cols] = k.to(ck.dtype)          # in-place per-row write
            cv[rows, cols] = v.to(cv.dtype)
            kv_valid = kpos < cache_index[:, None] + S
        else:
            i = int(cache_index)
            ck[:, i:i + S] = k.to(ck.dtype)          # in-place write
            cv[:, i:i + S] = v.to(cv.dtype)
            kv_valid = kpos < i + S
        out = flash_attention(q, ck, cv, positions, kpos, window,
                              kv_valid=kv_valid, ragged=ragged)
    out = engine.dense(out.reshape(B, S, H * hd), p["w_o"])
    return out, cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    u = engine.dense(x, p["mlp_up"])
    if "mlp_gate" in p:
        h = silu(engine.dense(x, p["mlp_gate"])) * u
    else:
        h = F.gelu(u, approximate="tanh")
    return engine.dense(h, p["mlp_down"])
