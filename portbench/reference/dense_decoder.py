"""Plain PyTorch reference of a dense decoder, and the weights the benchmark
hands to both sides.

Nothing here imports the program under test. The weights are drawn from the
run's seed on the device, in the parameter layout the port takes
(``params=`` of its serve engine): ``embed`` (Vp, d) with the vocabulary
padded to a multiple of 256, ``layers`` with every per-layer leaf stacked on a
leading layer dimension, ``final_norm``, and ``lm_head`` (d, Vp) where the
embeddings are not tied. The same tensors go to the port and to this
reference, which works everything else out again from them: no combined
weights, no cache, no batching.

The reference follows the published decoder: RMSNorm, rotary positions on
the two halves of each head, grouped-query causal attention, SwiGLU. Its
scalar multipliers (``embedding_multiplier``, ``residual_multiplier``,
``attention_multiplier``, ``logits_scaling``) are read from the
configuration as run (``as_run``): the file's published values, with any
the program departs from replaced by the file's ``run_as``.

``precision="float32"`` computes every product in float32 with TF32 off.
``precision="fp8"`` is the control a lower precision gives: the operands of
every projection and the LM head rounded to float8 e4m3 (activations per
row, weights per output column, each scaled by its largest magnitude) and
the keys and values rounded to e4m3 per head vector, as an fp8 KV cache
holds them; the rest stays in float32.
"""
from __future__ import annotations

import torch

__all__ = ["padded_vocab", "as_run", "dims", "make_weights", "Reference"]

FP8_MAX = 448.0             # the largest finite float8 e4m3 magnitude
QUERY_BLOCK = 1024          # query rows per block of attention scores


def padded_vocab(vocab: int) -> int:
    """The vocabulary rounded up to a multiple of 256, as the port pads it."""
    return -(-vocab // 256) * 256


def as_run(spec: dict) -> dict:
    """The configuration as the run computes it: the file's published keys
    with its ``run_as`` values (what the program runs where it departs from
    the published model) laid over them."""
    return {**spec, **spec.get("run_as", {})}


def dims(spec: dict) -> dict:
    """The sizes of a dense decoder from its configuration file."""
    d, heads = spec["hidden_size"], spec["num_attention_heads"]
    return {"layers": spec["num_hidden_layers"], "d": d, "heads": heads,
            "kv_heads": spec["num_key_value_heads"],
            "head_dim": spec.get("head_dim") or d // heads,
            "ff": spec["intermediate_size"], "vocab": spec["vocab_size"],
            "tied": bool(spec["tie_word_embeddings"]),
            "dtype": getattr(torch, spec["torch_dtype"])}


def make_weights(spec: dict, seed: int, device) -> dict:
    """Seeded random weights in the port's layout, drawn on ``device`` in
    the served dtype, one generator call a stacked leaf. Projections are
    Normal(0, 1/fan_in), embeddings Normal(0, 0.02^2), norm scales
    1 + Normal(0, 0.1^2), so the norms' scales are exercised too."""
    z = dims(spec)
    L, d, H, Hkv, hd, ff = z["layers"], z["d"], z["heads"], z["kv_heads"], z["head_dim"], z["ff"]
    Vp = padded_vocab(z["vocab"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)

    def draw(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, dtype=z["dtype"], device=device)
        return t.mul_(std).add_(mean) if mean else t.mul_(std)

    layers = {
        "ln1": draw((L, d), 0.1, 1.0),
        "attn": {"w_q": draw((L, d, H * hd), d ** -0.5),
                 "w_k": draw((L, d, Hkv * hd), d ** -0.5),
                 "w_v": draw((L, d, Hkv * hd), d ** -0.5),
                 "w_o": draw((L, H * hd, d), (H * hd) ** -0.5)},
        "ln2": draw((L, d), 0.1, 1.0),
        "mlp": {"mlp_gate": draw((L, d, ff), d ** -0.5),
                "mlp_up": draw((L, d, ff), d ** -0.5),
                "mlp_down": draw((L, ff, d), ff ** -0.5)},
    }
    params = {"embed": draw((Vp, d), 0.02), "layers": layers, "final_norm": draw((d,), 0.1, 1.0)}
    if not z["tied"]:
        params["lm_head"] = draw((d, Vp), d ** -0.5)
    return params


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled by its largest magnitude along
    ``dim``, back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (S, heads, hd): the first half of each
    head rotated against the second."""
    S, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """The decoder's logits at chosen positions of whole sequences."""

    def __init__(self, spec: dict, weights: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: float32 or fp8")
        self.spec, self.w, self.fp8 = spec, weights, precision == "fp8"
        self.z = dims(spec)
        self.eps = float(spec["rms_norm_eps"])
        self.theta = float(spec["rope_theta"])
        self.emb_mult = float(spec.get("embedding_multiplier", 1.0))
        self.res_mult = float(spec.get("residual_multiplier", 1.0))
        self.attn_mult = float(spec.get("attention_multiplier", self.z["head_dim"] ** -0.5))
        self.logit_div = float(spec.get("logits_scaling", 1.0))

    def _norm(self, x, scale):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.eps) * scale.float()

    def _proj(self, x, w):
        """x (S, K) @ w (K, N), w already float32 (rounded, under fp8)."""
        return (_fp8(x, -1) if self.fp8 else x) @ w

    def _weight(self, w):
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def _attention(self, x, p):
        z = self.z
        S = x.shape[0]
        H, Hkv, hd = z["heads"], z["kv_heads"], z["head_dim"]
        q = _rope(self._proj(x, p["w_q"]).view(S, H, hd), self.theta)
        k = _rope(self._proj(x, p["w_k"]).view(S, Hkv, hd), self.theta)
        v = self._proj(x, p["w_v"]).view(S, Hkv, hd)
        if self.fp8:
            k, v = _fp8(k, -1), _fp8(v, -1)
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, S, hd)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = torch.empty((H, S, hd), dtype=torch.float32, device=x.device)
        for s0 in range(0, S, QUERY_BLOCK):
            s1 = min(S, s0 + QUERY_BLOCK)
            scores = (q[:, s0:s1] @ k[:, :s1].transpose(1, 2)) * self.attn_mult
            qpos = torch.arange(s0, s1, device=x.device)[:, None]
            kpos = torch.arange(s1, device=x.device)[None, :]
            scores = scores.masked_fill(kpos > qpos, float("-inf"))
            out[:, s0:s1] = torch.softmax(scores, dim=-1) @ v[:, :s1]
        return self._proj(out.transpose(0, 1).reshape(S, H * hd), p["w_o"])

    def _layer(self, x, p):
        h = self._norm(x, p["ln1"])
        x = x + self.res_mult * self._attention(h, p)
        h = self._norm(x, p["ln2"])
        g, u = self._proj(h, p["mlp_gate"]), self._proj(h, p["mlp_up"])
        return x + self.res_mult * self._proj(torch.nn.functional.silu(g) * u, p["mlp_down"])

    @torch.no_grad()
    def logits(self, sequences: list, positions: list) -> list:
        """Logits (len(positions[i]), vocab) in float32 over the real
        vocabulary, at ``positions[i]`` of ``sequences[i]`` (token ids),
        each sequence attending causally to itself. The stack runs one layer
        at a time over every sequence, with that layer's weights alone in
        float32, so it fits beside weights of any served size."""
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(sequences, positions)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def _logits(self, sequences, positions):
        w, z = self.w, self.z
        embed = w["embed"]
        xs = [embed[torch.as_tensor(s, device=embed.device)].float() * self.emb_mult
              for s in sequences]
        layers = w["layers"]
        for i in range(z["layers"]):
            p = {"ln1": layers["ln1"][i], "ln2": layers["ln2"][i]}
            p.update({n: self._weight(t[i]) for n, t in layers["attn"].items()})
            p.update({n: self._weight(t[i]) for n, t in layers["mlp"].items()})
            xs = [self._layer(x, p) for x in xs]
            del p
        V = z["vocab"]
        head = self._weight(embed[:V].T if z["tied"] else w["lm_head"][:, :V])
        out = []
        for x, pos in zip(xs, positions):
            h = self._norm(x[torch.as_tensor(pos, device=x.device)], w["final_norm"])
            out.append(self._proj(h, head) / self.logit_div)
        return out

