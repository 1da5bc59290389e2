"""Calibrate a hardware target and warm the persistent plan cache.

  python -m repro_torch.tools.tune --dtype bfloat16 --quant

does three things:

  1. runs the empirical autotuner (``core.autotune``) on the card (or, with
     ``--device cpu``, through the kernels' plain versions) — times the
     tiled GEMM, Group Combine A and the fused R-batched LCMA GEMM stage on
     a probe grid (``--backend torch``: ``torch.matmul``, the generated
     Combine A and batched product, and the grouped stage) and fits
     effective ``(FLOPS_x, FLOPS_+, beta, lcma_gemm_efficiency)``;
     ``--quant`` adds the int8 GEMM and the quantizing Combine A. On a card
     the probes are timed on the device (``autotune.device_timer``), on the
     CPU on the host clock; ``--host-clock`` also fits them on the host
     clock (``autotune.best_of_timer``) and prints that fit beside the
     written one;
  2. writes the calibrated :class:`HardwareProfile` as JSON (default:
     ``~/.cache/falcon_gemm/profiles/<name>.json``, override with
     ``FALCON_PROFILE_DIR`` or ``--out``) with the probe measurements and
     per-scheme Hopper block plans as metadata;
  3. warms the plan cache for a grid of serving shapes — the projection
     pairs of ``--warm-workload``'s contraction set x token buckets
     (``core.workloads.warm_shapes``) — under the calibrated profile and
     saves it next to the profile, for ``repro_torch.launch.serve
     --plan-cache ...``.

``--train`` calibrates and warms for training: the probe shapes gain their
backward (transposed) triples, and the warm pass plans each shape's
forward, dA and dB (``falcon_gemm.plan_training``).

After tuning, both of these resolve the calibrated numbers:

  FalconConfig(hardware="<base>_autotuned")
  decision.decide(M, N, K, "<base>_autotuned")
"""
from __future__ import annotations

import argparse
import os


def _parse_shape(s: str) -> tuple[int, int, int]:
    parts = [int(x) for x in s.replace("x", ",").split(",") if x]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"shape must be M,K,N — got {s!r}")
    return tuple(parts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tools.tune",
        description="Empirical autotune + plan-cache warmup for FalconGEMM.")
    ap.add_argument("--hardware", default="h100_sxm",
                    help="base profile name to calibrate (default: h100_sxm)")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                    help="cuda: the hand-written kernels; torch: the generated "
                         "code around torch.matmul (also probes the grouped "
                         "stage)")
    ap.add_argument("--device", default="cuda",
                    help="where the probes run (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--scheme", default="strassen",
                    help="probe LCMA used for combine/batched measurements")
    ap.add_argument("--shape", action="append", type=_parse_shape, default=None,
                    metavar="M,K,N", help="probe shape (repeatable)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--name", default=None,
                    help="name for the calibrated profile "
                         "(default: <hardware>_autotuned)")
    ap.add_argument("--out", default=None,
                    help="profile JSON path (default: profile dir / <name>.json)")
    ap.add_argument("--no-warm", dest="warm", action="store_false",
                    help="skip plan-cache warmup")
    ap.add_argument("--warm-dtype", default="bfloat16",
                    help="dtype for plan-cache warmup decisions")
    ap.add_argument("--warm-workload", default="deepseek_r1",
                    help="workload whose registry contraction set seeds the "
                         "warm grid: a paper workload (deepseek_r1/qwen3_5/"
                         "hunyuan_video) or a configs.registry arch id "
                         "(default: deepseek_r1)")
    ap.add_argument("--quant", action="store_true",
                    help="probe the int8 stage too (int8 GEMM + fused "
                         "Combine-A+quantize) and persist the measured "
                         "FLOPS_int8 as the profile's dtype_flops['int8'] — "
                         "what the quantized decision tier is priced with")
    ap.add_argument("--collectives", action="store_true",
                    help="probe the all-gather/reduce-scatter bandwidth over the "
                         "process group of this rank's mesh (collective_bw, priced "
                         "by the sharded decision tier); skipped on a world of one, "
                         "and not recorded where gloo ranks share a card")
    ap.add_argument("--host-clock", action="store_true",
                    help="also fit the probes on the host clock (best of --reps, each "
                         "call synchronized) and print that fit beside the profile's; "
                         "the profile written is the first fit's")
    ap.add_argument("--quick", action="store_true",
                    help="smoke run: small probe shapes, one rep, reduced "
                         "plan-cache warm grid")
    ap.add_argument("--train", action="store_true",
                    help="calibrate + warm for training: probe shapes gain "
                         "their backward (transposed) variants and the plan "
                         "cache is warmed with full fwd+dA+dB shape triples")
    args = ap.parse_args(argv)
    if args.quick:
        args.reps, args.warmup = 1, 0
        if args.shape is None:
            args.shape = [(192, 192, 192), (384, 384, 384)]
    if args.train:
        # The backward GEMMs run the same kernels at transposed aspect ratios
        # (M, N, K) / (K, M, N), so the fit sees those shapes too, also when
        # no --shape was given (the grid then starts from the autotuner's
        # defaults); duplicates are dropped.
        from repro_torch.core.autotune import default_probe_shapes
        from repro_torch.core.decision import backward_shapes
        if args.shape is None:
            args.shape = default_probe_shapes(args.backend)
        seen = set(args.shape)
        for s in list(args.shape):
            for sb in backward_shapes(*s):
                if sb not in seen:
                    seen.add(sb)
                    args.shape.append(sb)

    from repro_torch.core import autotune, plan_cache
    from repro_torch.core.falcon_gemm import FalconConfig, plan, plan_training
    from repro_torch.core.hardware import get_profile
    from repro_torch.core.workloads import warm_shapes

    base = get_profile(args.hardware)
    print(f"calibrating {base.name!r} via backend={args.backend} "
          f"device={args.device} dtype={args.dtype} scheme={args.scheme} ...")
    report, path = autotune.calibrate(
        path=args.out, base=args.hardware, backend=args.backend,
        shapes=args.shape, dtype=args.dtype, scheme=args.scheme,
        reps=args.reps, warmup=args.warmup, name=args.name,
        quant=args.quant, device=args.device, collectives=args.collectives,
        host_clock=args.host_clock)
    prof = report.profile
    host = None
    if args.host_clock:
        import json
        with open(path) as f:
            host = json.load(f)["_metadata"]["host_clock"]

    def tera(x):
        return f"{x / 1e12:8.3f}T"

    def hcol(key, fmt=tera):
        return f" {fmt(host[key])}" if host else ""

    print(f"wrote {path} (probes timed on the {report.clock} clock)")
    print(f"  {'quantity':24s} {'static':>10s} {'calibrated':>10s}"
          + (f" {'host clock':>10s}" if host else ""))
    print(f"  {'FLOPS_x (matmul)':24s} {tera(base.flops_for(args.dtype))} "
          f"{tera(prof.flops_mul)}{hcol('flops_mul')}")
    print(f"  {'FLOPS_+ (elementwise)':24s} {tera(base.flops_add)} "
          f"{tera(prof.flops_add)}{hcol('flops_add')}")
    print(f"  {'beta (bytes/s)':24s} {tera(base.beta)} {tera(prof.beta)}{hcol('beta')}")
    print(f"  {'lcma_gemm_efficiency':24s} {base.lcma_gemm_efficiency:10.3f} "
          f"{prof.lcma_gemm_efficiency:10.3f}"
          f"{hcol('lcma_gemm_efficiency', lambda v: f'{v:10.3f}')}")
    if args.quant and report.flops_int8 is not None:
        print(f"  {'FLOPS_int8 (quant GEMM)':24s} "
              f"{tera(base.flops_for('int8'))} {tera(report.flops_int8)}")
        print(f"  {'beta_quant (bytes/s)':24s} {'':>10s} "
              f"{tera(report.beta_quant)}")
    if args.collectives:
        if report.collective_bw is None:
            print(f"  collective probe skipped: a world of one "
                  f"(link_bw fallback {tera(base.coll_bw())})")
        elif report.collective_recorded:
            print(f"  {'collective_bw (bytes/s)':24s} {tera(base.coll_bw())} "
                  f"{tera(prof.collective_bw)}")
        else:
            print(f"  collective probe: {tera(report.collective_bw)}B/s over "
                  f"{report.collective_backend}, ranks sharing one card (host staging, "
                  f"not a link's rate): not recorded")
    if report.eff_grouped is not None:
        print(f"  grouped GEMM stage eff: measured {report.eff_grouped:.3f} "
              f"vs eff_B model {report.eff_grouped_predicted:.3f}")
    if report.max_rel_err is not None:
        print(f"  model-vs-measured pipeline rel.err: "
              f"max {report.max_rel_err:.1%} over {len(report.model_rel_err)} probes"
              + (f" (host clock: max {max(host['model_rel_err']):.1%})"
                 if host and host["model_rel_err"] else ""))

    if args.warm:
        # next to the profile JSON, wherever --out put it
        cache_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                                  f"{prof.name}.plans.json")
        cache = plan_cache.configure(path=cache_path, autoload=False)
        cfg = FalconConfig(hardware=prof.name)
        n_lcma = 0
        shapes = warm_shapes(args.warm_workload)
        if args.quick:
            shapes = shapes[:8]
        for (m, k, n) in shapes:
            if args.train:
                for d in plan_training(m, k, n, cfg, dtype=args.warm_dtype):
                    n_lcma += int(d.use_lcma)
            else:
                d = plan(m, k, n, cfg, dtype=args.warm_dtype)
                n_lcma += int(d.use_lcma)
        cache.save()
        kind = "fwd+bwd triples" if args.train else "plans"
        print(f"warmed plan cache: {len(cache)} {kind} "
              f"({n_lcma} pick an LCMA) -> {cache_path}")
        # The launcher prices on the model's own profile, so its --plan-cache
        # hits none of these plans (their keys carry this profile's
        # fingerprint): serving under the calibration goes through the API.
        print(f"serve under it: launch.serve.run_oneshot inside "
              f"falcon.use(FalconConfig(hardware={prof.name!r})), after "
              f"plan_cache.configure(path={cache_path!r})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
