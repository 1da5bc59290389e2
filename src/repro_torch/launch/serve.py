"""One-shot serving: batched prefill, then greedy decode in lockstep.

    python -m repro_torch.launch.serve --arch granite_3_2b --full [--quant]
        [--plan-cache PATH]

runs on the card (``--device cuda``, the default) or, with ``--device cpu``,
through the kernels' plain versions. Static weights are lifted to
PlannedWeights (offline Combine B) where the Decision Module picks an LCMA;
``--quant`` puts the int8 tier into its search and bakes int8 B̃q into the
PlannedWeights. ``--plan-cache`` loads a plan cache warmed by
``repro_torch.tools.tune`` before serving and flushes it after. The
continuous-batching engine comes with a later slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch.api as falcon
from repro_torch import kernels
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan_cache
from repro_torch.core.engine import PlannedWeight, active_config
from repro_torch.models import model as M
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["run_oneshot", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _quantized_leaves(params, path: str = "") -> list[str]:
    """Paths (``layers/mlp/mlp_up``) of the planned leaves with int8 B̃q."""
    if isinstance(params, dict):
        return [p for k, v in params.items()
                for p in _quantized_leaves(v, f"{path}/{k}" if path else k)]
    return [path] if isinstance(params, PlannedWeight) and params.quantized else []


def run_oneshot(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 64,
                gen: int = 32, seed: int = 0, device="cuda",
                precombine: bool = True, params: dict | None = None,
                quantize: bool = False) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens for ``gen``
    greedy tokens each.

    ``params`` defaults to ``init_params(cfg, seed, device)``. The FalconGEMM
    policy is the ambient config, else the model's ``falcon_config_for``;
    ``quantize=True`` turns its int8 tier on. Returns
    ``tokens`` (batch, gen) int64 on the CPU, ``logits`` (the last-position
    logits of the prefill and of every decode step, each (batch, Vp)),
    ``n_precombined``, ``quantized`` (the paths of the planned leaves that
    carry int8 B̃q) and ``n_quantized``, ``timings`` (host clock,
    synchronized) and ``launches`` (kernel launches per phase).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_oneshot: no CUDA device (pass device='cpu' to "
                           "run the kernels' plain versions)")
    fcfg = active_config() or M.falcon_config_for(cfg)
    if quantize:
        fcfg = dataclasses.replace(fcfg, quantize=True)
    if params is None:
        params = M.init_params(cfg, seed, device)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                              device=device)
    prefill = make_prefill_step(cfg, max_len=prompt_len + gen)
    decode = make_decode_step(cfg)
    launches = {}

    def phase(name, fn):
        before = kernels.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        after = kernels.launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        return out, time.perf_counter() - t0

    with falcon.use(fcfg), torch.inference_mode():
        n_planned = 0
        t_pre = 0.0
        if precombine:
            # Offline Combine B against the prefill shape (the M the Decision
            # Module should price); decode re-decides per its own tiny M.
            (params, n_planned), t_pre = phase(
                "precombine", lambda: falcon.precombine_params(
                    params, m_hint=batch * prompt_len))
        (logits, cache), t_prefill = phase("prefill", lambda: prefill(params, prompts))
        all_logits = [logits[:, -1]]
        out_tokens = []

        def decode_all():
            nonlocal logits
            for i in range(gen):
                nxt = torch.argmax(logits[:, -1], dim=-1)
                out_tokens.append(nxt)
                if i + 1 < gen:
                    logits, _ = decode(params, cache, nxt[:, None], prompt_len + i)
                    all_logits.append(logits[:, -1])

        _, t_decode = phase("decode", decode_all)
    n_steps = max(gen - 1, 1)
    quantized = _quantized_leaves(params)
    return {
        "tokens": torch.stack(out_tokens, 1).cpu(),
        "logits": all_logits,
        "n_precombined": n_planned,
        "quantized": quantized,
        "n_quantized": len(quantized),
        "timings": {"precombine_s": t_pre, "prefill_ms": t_prefill * 1e3,
                    "decode_ms_per_step": t_decode / n_steps * 1e3,
                    "decode_steps": gen - 1,
                    "tokens_per_s": batch * gen / (t_prefill + t_decode)},
        "launches": launches,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: a reduced smoke config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-precombine", dest="precombine", action="store_false")
    ap.add_argument("--quant", action="store_true",
                    help="serve with the int8-quantized decision tier: the "
                         "Decision Module prices quantized execution next to "
                         "fp, and planned weights carry offline-quantized "
                         "B̃q + scales")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="persistent Decision plan cache (JSON, written by "
                         "repro_torch.tools.tune); loaded before serving and "
                         "flushed back on exit")
    args = ap.parse_args(argv)
    if args.plan_cache:
        cache = plan_cache.configure(path=args.plan_cache)
        print(f"plan cache: {len(cache)} plans loaded from {args.plan_cache}")
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    res = run_oneshot(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, seed=args.seed, device=args.device,
                      precombine=args.precombine, quantize=args.quant)
    t = res["timings"]
    print(f"offline Combine B: {res['n_precombined']} weight tensor(s) "
          f"precombined into PlannedWeights, {res['n_quantized']} with int8 B̃q")
    print(f"prefill: {t['prefill_ms']:.1f} ms for {args.batch}x{args.prompt_len} tokens")
    print(f"decode:  {t['decode_ms_per_step']:.2f} ms/step "
          f"({t['tokens_per_s']:.1f} tok/s overall)")
    print("sample:", res["tokens"][0, :16].tolist())
    st = plan_cache.stats()
    print(f"plan cache: {st.hits} hits / {st.misses} misses "
          f"({st.hit_rate:.0%} hit rate, {len(plan_cache.default_cache())} plans)")
    if args.plan_cache:
        plan_cache.flush()


if __name__ == "__main__":
    main()
