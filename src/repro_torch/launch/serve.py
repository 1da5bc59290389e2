"""Serving launcher: a thin CLI over the serving engines.

Two modes share the FalconGEMM serving stack (context-scoped config, offline
Combine B via ``PlannedWeight``, persistent plan cache):

* ``--continuous``: the continuous-batching
  :class:`repro_torch.serve.ServeEngine`. ``--requests N`` synthetic
  requests with ragged prompt lengths are admitted through bucketed prefill
  micro-batches and decoded with per-slot positions; the engine pre-plans
  the whole bucket grid and, on the card, captures each bucket's step as a
  CUDA graph (``--no-warm`` opts out of warming, ``--no-cuda-graphs`` runs
  the steps eagerly), then prints the ``ServeStats`` surface (tokens/s,
  bucket hit rate, plan-cache hit rate, padding waste).
* default: one-shot batched prefill + greedy decode in lockstep
  (:func:`run_oneshot`).

    python -m repro_torch.launch.serve --arch granite_3_2b --full [--quant]
        [--plan-cache PATH] [--layers N] [--continuous --requests 32 [--speculate 2]
        [--prefix-cache] [--prefill-chunk 16] [--no-cuda-graphs]]
        [--mesh 1,2 [--dist-backend gloo]]

runs on the card (``--device cuda``, the default) or, with ``--device cpu``,
through the kernels' plain versions. ``--mesh DATA,MODEL`` (DATA = 1)
serves tensor- and expert-parallel over MODEL ranks, one-shot or
``--continuous``: the launcher starts one process per rank itself
(``parallel.mesh.run_ranks``), unless ``RANK``/``WORLD_SIZE`` say it is one
already (``torchrun``); ``--dist-backend`` is ``nccl`` (a card per rank) or
``gloo`` (ranks sharing a card, or on the CPU), chosen by the visible cards
when not given, and printed. Rank 0 prints. Static weights are lifted to
PlannedWeights (offline Combine B) where the Decision Module picks an LCMA;
``--quant`` puts the int8 tier into its search and bakes int8 B̃q into the
PlannedWeights. ``--plan-cache`` loads a plan cache warmed by
``repro_torch.tools.tune`` before serving and flushes it after.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys
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
from repro_torch.parallel import mesh as PM, sharding as SH
from repro_torch.serve import ServeEngine, StepLoop
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["run_oneshot", "oneshot_inputs", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _quantized_leaves(params, path: str = "") -> list[str]:
    """Paths (``layers/mlp/mlp_up``) of the planned leaves with int8 B̃q."""
    if isinstance(params, dict):
        return [p for k, v in params.items()
                for p in _quantized_leaves(v, f"{path}/{k}" if path else k)]
    return [path] if isinstance(params, PlannedWeight) and params.quantized else []


def oneshot_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed: int, device):
    """The one-shot serve's inputs, drawn from ``seed``: the prompts (batch,
    prompt_len) int64 ((batch, prompt_len, CB) codebook tokens for audio),
    then a vlm's patch embeddings (batch, num_patches, d) in the model's
    dtype (else None), and the position the first decode step writes."""
    rng = np.random.default_rng(seed)
    shape = (batch, prompt_len) + ((cfg.num_codebooks,)
                                   if cfg.frontend == "audio_codebooks" else ())
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape), device=device)
    if cfg.frontend != "vision_patches":
        return prompts, None, prompt_len
    patches = torch.as_tensor(rng.standard_normal((batch, cfg.num_patches, cfg.d_model)),
                              device=device).to(getattr(torch, cfg.dtype))
    return prompts, patches, prompt_len + cfg.num_patches


def run_oneshot(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 64,
                gen: int = 32, seed: int = 0, device="cuda",
                precombine: bool = True, params: dict | None = None,
                quantize: bool = False, mesh_shape: dict | None = None) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens for ``gen``
    greedy tokens each.

    ``params`` defaults to ``init_params(cfg, seed, device)``. The FalconGEMM
    policy is the ambient config, else the model's ``falcon_config_for``;
    ``quantize=True`` turns its int8 tier on. An audio model's prompts are
    (batch, prompt_len, CB) codebook tokens; a vlm's prompts follow
    ``num_patches`` random patch embeddings, drawn after the tokens from the
    same generator, so its decode starts at ``prompt_len + num_patches`` and
    its cache holds ``prompt_len + num_patches + gen`` positions (the
    reference's launcher leaves the patches out of its cache length). Returns
    ``tokens`` (batch, gen) int64 on the CPU ((batch, gen, CB) for audio),
    ``logits`` (the last-position logits of the prefill and of every decode
    step, each (batch, Vp), or (batch, CB, Vp) for audio),
    ``n_precombined``, ``quantized`` (the paths of the planned leaves that
    carry int8 B̃q) and ``n_quantized``, ``timings`` (host clock,
    synchronized) and ``launches`` (kernel launches per phase).

    ``mesh_shape`` ({"model": m}, m > 1) serves on this rank of this
    process's mesh (``parallel.mesh``): ``params`` (the full tree, or the
    seed's) are sharded by the rule table before precombining, and the
    result adds ``mesh`` (the mesh, its backend, and its collectives'
    counters per phase under ``collectives``).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_oneshot: no CUDA device (pass device='cpu' to "
                           "run the kernels' plain versions)")
    fcfg = active_config() or M.falcon_config_for(cfg)
    if quantize:
        fcfg = dataclasses.replace(fcfg, quantize=True)
    if PM.mesh_factors(mesh_shape)[0] > 1:
        raise NotImplementedError(f"mesh_shape={mesh_shape}: a data axis is not ported to "
                                  "serving (ROADMAP Queue 1 item 6b; training runs one)")
    mesh = PM.mesh_for(mesh_shape)
    if params is None:
        params = M.init_params(cfg, seed, device)
    if mesh is not None:
        params = SH.shard_params(params, cfg, mesh)
    prompts, patches, pos0 = oneshot_inputs(cfg, batch, prompt_len, seed, device)
    prefill = make_prefill_step(cfg, max_len=pos0 + gen)
    decode = make_decode_step(cfg)
    launches, collectives = {}, {}

    def phase(name, fn):
        before = kernels.launch_counts()
        coll = mesh and mesh.stats.as_dict()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        after = kernels.launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        if mesh is not None:
            now = mesh.stats.as_dict()
            collectives[name] = {k: now[k] - coll[k] for k in
                                 ("payload_bytes", "staged_bytes", "collective_ms")}
        return out, time.perf_counter() - t0

    with falcon.use(fcfg), PM.use_mesh(mesh), torch.inference_mode():
        n_planned = 0
        t_pre = 0.0
        if precombine:
            # Offline Combine B against the prefill shape (the M the Decision
            # Module should price); decode re-decides per its own tiny M.
            (params, n_planned), t_pre = phase(
                "precombine", lambda: falcon.precombine_params(
                    params, m_hint=batch * prompt_len))
        (logits, cache), t_prefill = phase("prefill",
                                           lambda: prefill(params, prompts, patches))
        all_logits = [logits[:, -1]]
        out_tokens = []

        def decode_all():
            nonlocal logits
            for i in range(gen):
                nxt = torch.argmax(logits[:, -1], dim=-1)     # (B,), or (B, CB)
                out_tokens.append(nxt)
                if i + 1 < gen:
                    logits, _ = decode(params, cache, nxt[:, None], pos0 + i)
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
        "mesh": None if mesh is None else {**mesh.summary(), "collectives": collectives},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: a reduced smoke config)")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="cut the depth to N layers (dbrx_132b and kimi_k2_1t do "
                         "not fit one card at their published depth)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-precombine", dest="precombine", action="store_false")
    ap.add_argument("--quant", action="store_true",
                    help="serve with the int8-quantized decision tier: the "
                         "Decision Module prices quantized execution next to "
                         "fp, planned weights carry offline-quantized "
                         "B̃q + scales, and warm() pre-plans the quantized "
                         "buckets (--continuous)")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="persistent Decision plan cache (JSON, written by "
                         "repro_torch.tools.tune); loaded before serving and "
                         "flushed back on exit")
    # continuous-batching engine
    ap.add_argument("--continuous", action="store_true",
                    help="serve --requests jobs through the continuous-"
                         "batching engine instead of one lockstep batch")
    ap.add_argument("--requests", type=int, default=32,
                    help="number of synthetic requests (--continuous)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="concurrent decode slots (--continuous)")
    ap.add_argument("--min-prompt-len", type=int, default=4,
                    help="ragged prompt lower bound (--continuous)")
    ap.add_argument("--warm", action="store_true", default=True,
                    help="pre-plan the bucket grid and prepare (on the card: "
                         "capture) every step before serving (--continuous)")
    ap.add_argument("--no-warm", dest="warm", action="store_false")
    ap.add_argument("--no-cuda-graphs", dest="cuda_graphs", action="store_false",
                    help="run each bucket's step eagerly instead of replaying "
                         "its captured CUDA graph (--continuous)")
    ap.add_argument("--speculate", type=int, default=0, metavar="GAMMA",
                    help="speculative decoding: a self-draft proposes GAMMA "
                         "tokens per round, one (batch, GAMMA+1) verify "
                         "forward accepts greedily: token-exact (--continuous)")
    ap.add_argument("--draft-layers", type=int, default=None, metavar="N",
                    help="slice the draft to the target's first N layers "
                         "(default: all layers = identity draft)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix-KV cache: repeated or extended "
                         "prompts skip prefilling the shared prefix "
                         "(--continuous)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="S",
                    help="split long prompts into S-token prefill chunks "
                         "(S must be a prefill bucket) interleaved with "
                         "decode (--continuous)")
    ap.add_argument("--stream", action="store_true",
                    help="print the first request's tokens as they are "
                         "emitted (--continuous)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve tensor- and expert-parallel over a (data, model) "
                         "mesh, e.g. --mesh 1,2: one process per rank, started by "
                         "the launcher unless RANK/WORLD_SIZE are set (torchrun)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend (--mesh): nccl where every "
                         "rank has a card, gloo where ranks share one or run on the "
                         "CPU (default: by the visible cards)")
    args = ap.parse_args(argv)
    args.mesh_shape = _parse_mesh(args.mesh)
    world = math.prod(args.mesh_shape.values()) if args.mesh_shape else 1
    if world <= 1:
        _serve(args)
        return
    backend = args.dist_backend or PM.choose_backend(args.device, world)
    if "RANK" not in os.environ:
        # one process per rank, each joined through a file store of its own
        PM.run_ranks(_serve_rank, args.mesh_shape, args, backend=backend,
                     device=args.device, timeout=None)
        return
    mesh = PM.init_mesh(args.mesh_shape, backend, device=args.device)   # torchrun's rank
    try:
        _serve_rank(mesh, args)
    finally:
        PM.shutdown()


def _serve(args) -> None:
    if args.plan_cache:
        cache = plan_cache.configure(path=args.plan_cache)
        print(f"plan cache: {len(cache)} plans loaded from {args.plan_cache}")
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.continuous:
        _run_continuous(cfg, args)
    else:
        _print_oneshot(cfg, args)
    if args.plan_cache:
        plan_cache.flush()


def _parse_mesh(spec: str | None) -> dict:
    """"DATA,MODEL" -> {"data": DATA, "model": MODEL} (empty without --mesh)."""
    if not spec:
        return {}
    parts = [int(x) for x in spec.replace("x", ",").split(",") if x]
    if len(parts) != 2 or min(parts) < 1:
        raise SystemExit(f"--mesh expects DATA,MODEL (e.g. 1,8); got {spec!r}")
    return {"data": parts[0], "model": parts[1]}


def _serve_rank(mesh, args) -> None:
    """This process as one rank of ``--mesh``: it serves as every rank does,
    and prints only if it is rank 0."""
    with contextlib.redirect_stdout(sys.stdout if mesh.rank == 0 else open(os.devnull, "w")):
        cards = torch.cuda.device_count() if mesh.device.type == "cuda" else 0
        print(f"mesh: {mesh.shape} over {mesh.n_devices} ranks, backend {mesh.backend} "
              f"({'staged through pinned host memory, ' if mesh.staged else ''}"
              f"{mesh.n_devices} ranks on {cards or 'no'} card(s) of {mesh.device.type})")
        _serve(args)


def _print_oneshot(cfg: ModelConfig, args) -> None:
    res = run_oneshot(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, seed=args.seed, device=args.device,
                      precombine=args.precombine, quantize=args.quant,
                      mesh_shape=args.mesh_shape)
    t = res["timings"]
    print(f"offline Combine B: {res['n_precombined']} weight tensor(s) "
          f"precombined into PlannedWeights, {res['n_quantized']} with int8 B̃q")
    print(f"prefill: {t['prefill_ms']:.1f} ms for {args.batch}x{args.prompt_len} tokens")
    print(f"decode:  {t['decode_ms_per_step']:.2f} ms/step "
          f"({t['tokens_per_s']:.1f} tok/s overall)")
    print("sample:", res["tokens"][0].reshape(-1)[:16].tolist())
    if res["mesh"] is not None:
        _print_collectives(res["mesh"])
    st = plan_cache.stats()
    print(f"plan cache: {st.hits} hits / {st.misses} misses "
          f"({st.hit_rate:.0%} hit rate, {len(plan_cache.default_cache())} plans)")


def _run_continuous(cfg: ModelConfig, args) -> None:
    engine = ServeEngine(
        cfg, max_slots=args.max_slots, max_prompt_len=args.prompt_len,
        max_new_tokens=args.gen, precombine=args.precombine, seed=args.seed,
        quantize=args.quant, speculate=args.speculate,
        draft_keep_layers=args.draft_layers, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, device=args.device,
        cuda_graphs=args.cuda_graphs, mesh_shape=args.mesh_shape)
    print(f"engine: {args.max_slots} slots, cache len {engine.max_len}, "
          f"{engine.n_precombined} weight tensor(s) precombined"
          f"{' (int8-quantized tier on)' if args.quant else ''}, buckets "
          f"seq={list(engine.policy.prefill_seq)} "
          f"prefill_batch={list(engine.policy.prefill_batch)} "
          f"decode_batch={list(engine.policy.decode_batch)}")
    if args.warm:
        w = engine.warm()
        print(f"warmup: {w['plans']} Decision plans, {w['shapes']} step "
              f"shapes prepared in {w['seconds']:.1f}s ({w['plan_seconds']:.1f}s "
              f"planning, {w['capture_seconds']:.1f}s warm-up runs and captures; "
              f"{w['graphs']} CUDA graphs)")
    rng = np.random.default_rng(args.seed)
    lo = min(args.min_prompt_len, args.prompt_len)
    for i in range(args.requests):
        plen = int(rng.integers(lo, args.prompt_len + 1))
        engine.submit(
            rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=int(rng.integers(1, args.gen + 1)),
            on_token=((lambda r, t: print(f"  rid={r.rid} token {t}"))
                      if args.stream and i == 0 else None))
    t0 = time.perf_counter()
    done = StepLoop(engine).run_until_idle()
    wall = time.perf_counter() - t0
    s = engine.summary()
    print(f"served {len(done)}/{args.requests} requests in {wall:.2f}s: "
          f"{s['prompt_tokens']} prompt + {s['generated_tokens']} generated "
          f"tokens ({s['tokens_per_s']:.1f} tok/s real, "
          f"{s['decode_tokens_per_s']:.1f} decode tok/s)")
    print(f"steps: {s['prefill_steps']} prefill + {s['decode_steps']} decode "
          f"+ {s['verify_steps']} verify | "
          f"bucket hit rate {s['bucket_hit_rate']:.1%} | "
          f"padding waste {s['padding_waste']:.1%}")
    if args.speculate:
        print(f"speculation: gamma={args.speculate}, acceptance rate "
              f"{s['acceptance_rate']:.1%} "
              f"({s['accepted_tokens']}/{s['drafted_tokens']} drafts kept)")
    if args.prefix_cache and s.get("prefix_cache"):
        p = s["prefix_cache"]
        print(f"prefix cache: {p['hits']} hits / {p['misses']} misses, "
              f"{s['prefix_tokens_reused']} prompt tokens reused, "
              f"{p['entries']} entries ({p['evictions']} evicted)")
    pc = s["plan_cache"]
    print(f"plan cache: {pc['hits']} hits / {pc['misses']} misses "
          f"({pc['hit_rate']:.0%} hit rate, {pc['entries']} plans)")
    if done:
        sample = done[0]
        print(f"sample (rid={sample.rid}): {sample.generated[:16]}")
    if engine.mesh is not None:
        _print_collectives(s)


def _print_collectives(m: dict) -> None:
    """Rank 0's collectives: calls, bytes, staged bytes and host ms (on one
    shared card: the multi-process path's cost, not a link's rate)."""
    print(f"collectives ({m['backend']}): {m['collective_calls']}, "
          f"{m['payload_bytes']} payload bytes, {m['staged_bytes']} staged bytes, "
          f"{m['collective_ms']:.1f} ms on the host clock")


if __name__ == "__main__":
    main()
