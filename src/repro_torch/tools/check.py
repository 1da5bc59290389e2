"""falcon-check: static verification & lint CLI for the port's artifacts.

  PYTHONPATH=src python -m repro_torch.tools.check --all

runs every pass of ``repro_torch.analysis`` against the shipped artifacts and exits
non-zero iff any pass reports an *error* (warnings and info pass):

  * ``brent``        — exact integer verification of every library scheme's
    Brent equations (elementary schemes AND composition-operator outputs);
  * ``stability``    — Higham-style error-growth bounds per scheme (ERROR
    only when ``--budget`` is given and exceeded) plus int8 accumulator
    overflow bounds (``--quant-accum``);
  * ``plan-lint``    — ``kernels/tuning.block_plans`` output for each
    candidate scheme on the probe shapes, checked against the hardware
    profile and the Hopper launch limits (shared memory vs the profile's
    per-block ``vmem_bytes``, registers, threads, grid, tiles, splits);
    ``--workload <arch>`` runs the same lint over an architecture's FULL
    contraction set as enumerated by the workload registry
    (``core.workloads.contraction_set``) — every projection, expert FFN,
    attention and SSD contraction the model will plan, without launching a
    single kernel (the plain GEMMs' tiled plans and the grouped contractions'
    tensor-core plans included);
  * ``codegen-lint`` — the Deployment Module's generated source re-derived
    at the AST level against the scheme's coefficient tensors;
  * ``cache-audit``  — invariants of a persisted plan-cache JSON
    (``--cache PATH``; ``--all`` audits a freshly round-tripped cache).

Individual passes are selectable (``--library``, ``--plans``,
``--quant-plans``, ``--cache``, ``--scheme``, ``--scheme-file``,
``--quant-accum``); everything is static — no kernel is compiled or launched
by any code path in this tool, so it runs the same on a host with no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

DEFAULT_SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (512, 2048, 1024))


def _parse_shape(s: str) -> tuple[int, int, int]:
    parts = [int(x) for x in s.replace("x", ",").split(",") if x]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"shape must be M,K,N — got {s!r}")
    return tuple(parts)


def _parse_quant(s: str) -> tuple[int, int]:
    parts = [int(x) for x in s.split(",") if x]
    if len(parts) == 1:
        return parts[0], 32
    if len(parts) == 2:
        return parts[0], parts[1]
    raise argparse.ArgumentTypeError(
        f"quant-accum must be DEPTH or DEPTH,ACC_BITS — got {s!r}")


def _load_scheme_file(path: str):
    """Construct an (unregistered) LCMA from a JSON listing.

    The file format is the obvious one: ``{"name", "m", "k", "n", "R",
    "U", "V", "W"}`` with the coefficient tensors as nested lists — the same
    shape discipline as ``LCMA`` itself. Used to vet third-party or
    machine-generated listings *before* ``algorithms.register()`` (which
    would reject an invalid one by raising).
    """
    from repro_torch.core.lcma import LCMA

    with open(path) as f:
        doc = json.load(f)
    return LCMA(str(doc.get("name", os.path.basename(path))),
                int(doc["m"]), int(doc["k"]), int(doc["n"]), int(doc["R"]),
                np.asarray(doc["U"]), np.asarray(doc["V"]),
                np.asarray(doc["W"]))


def _check_scheme_full(l, *, budget, dtype, findings):
    """All scheme-local passes for one LCMA: brent, stability, codegen."""
    from repro_torch import analysis

    findings.extend(analysis.check_scheme(l))
    findings.extend(analysis.check_scheme_stability(l, budget=budget,
                                                    dtype=dtype))
    findings.extend(analysis.lint_codegen(l))


def _roundtrip_cache_audit(hw, dtype: str, findings) -> None:
    """Persist a freshly-decided plan cache to a temp file and audit it.

    Exercises the full encode -> JSON -> audit path (including scheme
    fingerprints) without touching any user cache file.
    """
    from repro_torch import analysis
    from repro_torch.core import decision as dec, plan_cache

    cache = plan_cache.PlanCache(capacity=16)
    for (M, K, N) in DEFAULT_SHAPES:
        d = dec.decide(M, N, K, hw, dtype)
        cache.insert(plan_cache.plan_key(M, K, N, hw, dtype), d)
    with tempfile.TemporaryDirectory() as td:
        path = cache.save(os.path.join(td, "plan_cache.json"))
        findings.extend(analysis.audit_cache_file(path, hw=hw))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="falcon-check",
        description="Static verification & lint for FalconGEMM schemes, "
                    "kernel plans and plan caches.")
    ap.add_argument("--all", action="store_true",
                    help="run every pass on the shipped artifacts")
    ap.add_argument("--library", action="store_true",
                    help="brent + stability over the scheme library")
    ap.add_argument("--plans", action="store_true",
                    help="lint candidate schemes' block plans on the probe "
                         "shapes against --hardware")
    ap.add_argument("--workload", action="append", default=[],
                    metavar="ARCH",
                    help="lint the full registry contraction set of an "
                         "architecture (configs.registry id or paper "
                         "workload name) against --hardware (repeatable; "
                         "--all lints every registry arch)")
    ap.add_argument("--workload-batch", type=int, default=8,
                    help="batch for --workload shape resolution (default 8)")
    ap.add_argument("--workload-seq", type=int, default=512,
                    help="seq for --workload shape resolution (default 512)")
    ap.add_argument("--quant-plans", action="store_true",
                    help="lint the int8-quantized pipeline each candidate "
                         "would run on the probe shapes: backend legality, "
                         "accumulator overflow, scale-block divisibility")
    ap.add_argument("--codegen", action="store_true",
                    help="AST-lint the generated source of every candidate")
    ap.add_argument("--cache", metavar="PATH",
                    help="audit a persisted plan-cache JSON file")
    ap.add_argument("--plan-file", action="append", default=[],
                    metavar="JSON",
                    help="lint a serialized block-plan dict (e.g. from a "
                         "calibrated profile's metadata) against --hardware")
    ap.add_argument("--scheme", action="append", default=[], metavar="NAME",
                    help="check one registered scheme (repeatable)")
    ap.add_argument("--scheme-file", action="append", default=[],
                    metavar="JSON",
                    help="check an unregistered scheme listing from a JSON "
                         "file (name/m/k/n/R/U/V/W)")
    ap.add_argument("--quant-accum", type=_parse_quant, metavar="DEPTH[,BITS]",
                    help="check an int8 reduction depth against the "
                         "accumulator width (default 32 bits)")
    ap.add_argument("--shape", action="append", type=_parse_shape,
                    default=None, metavar="M,K,N",
                    help="probe shape for --plans (repeatable; default "
                         f"{', '.join('x'.join(map(str, s)) for s in DEFAULT_SHAPES)})")
    ap.add_argument("--hardware", default="h100_sxm",
                    help="hardware profile name for --plans/--all "
                         "(default: h100_sxm)")
    ap.add_argument("--backend", default="cuda",
                    help="execution backend for dtype-legality lint: cuda, torch "
                         "or shard_map_local (default: cuda)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--budget", type=float, default=None,
                    help="accuracy budget: schemes whose error bound exceeds "
                         "it become stability ERRORs")
    ap.add_argument("--show-info", action="store_true",
                    help="include info-level findings in the report")
    args = ap.parse_args(argv)

    if not any((args.all, args.library, args.plans, args.quant_plans,
                args.codegen, args.cache, args.plan_file, args.scheme,
                args.scheme_file, args.quant_accum, args.workload)):
        ap.error("nothing to check: pass --all or a specific pass "
                 "(--library/--plans/--quant-plans/--workload/--codegen/"
                 "--cache/--plan-file/--scheme/--scheme-file/--quant-accum)")

    # Heavy imports after arg parsing so `--help` stays instant.
    from repro_torch import analysis
    from repro_torch.core import algorithms
    from repro_torch.core.hardware import get_profile

    findings: list = []
    shapes = tuple(args.shape) if args.shape else DEFAULT_SHAPES
    hw = get_profile(args.hardware)

    if args.all or args.library:
        findings.extend(analysis.check_library())
        findings.extend(analysis.check_library_stability(
            budget=args.budget, dtype="bfloat16"))

    if args.all or args.codegen:
        for l in algorithms.candidates():
            findings.extend(analysis.lint_codegen(l))

    if args.all or args.plans:
        for l in algorithms.candidates():
            findings.extend(analysis.lint_scheme_plans(
                l, shapes, hw, dtype=args.dtype, backend=args.backend))

    if args.all or args.quant_plans:
        for l in algorithms.candidates():
            findings.extend(analysis.lint_quant_plans(
                l, shapes, hw, backend=args.backend, dtype=args.dtype))

    workloads = list(args.workload)
    if args.all and not workloads:
        from repro_torch.configs import registry
        workloads = registry.list_archs()
    for arch in workloads:
        try:
            findings.extend(analysis.lint_workload(
                arch, hw, batch=args.workload_batch, seq=args.workload_seq,
                dtype=args.dtype, backend=args.backend))
        except (KeyError, ModuleNotFoundError) as e:
            print(f"falcon-check: unknown workload {arch!r}: {e}",
                  file=sys.stderr)
            return 2

    if args.all:
        _roundtrip_cache_audit(hw, "bfloat16", findings)

    if args.cache:
        findings.extend(analysis.audit_cache_file(args.cache, hw=hw))

    for path in args.plan_file:
        try:
            with open(path) as f:
                plan = json.load(f)
        except (OSError, ValueError) as e:
            print(f"falcon-check: cannot load plan file {path}: {e}",
                  file=sys.stderr)
            return 2
        findings.extend(analysis.lint_block_plan(
            plan, hw, dtype=args.dtype, backend=args.backend,
            subject=os.path.basename(path)))

    for name in args.scheme:
        try:
            l = algorithms.get(name)
        except KeyError as e:
            print(f"falcon-check: {e}", file=sys.stderr)
            return 2
        _check_scheme_full(l, budget=args.budget, dtype="bfloat16",
                           findings=findings)

    for path in args.scheme_file:
        try:
            l = _load_scheme_file(path)
        except (OSError, KeyError, ValueError) as e:
            print(f"falcon-check: cannot load scheme file {path}: {e}",
                  file=sys.stderr)
            return 2
        # No codegen lint here: the listing may be arbitrarily broken and the
        # point is to report brent/stability findings, not to generate code.
        findings.extend(analysis.check_scheme(l))
        findings.extend(analysis.check_scheme_stability(
            l, budget=args.budget, dtype="bfloat16"))

    if args.quant_accum:
        depth, bits = args.quant_accum
        findings.extend(analysis.check_quant_accumulator(depth, bits))

    print(analysis.format_findings(findings, show_info=args.show_info))
    n_err = sum(f.is_error for f in findings)
    n_warn = sum(f.severity == "warning" for f in findings)
    print(f"falcon-check: {len(findings)} finding(s), {n_err} error(s), "
          f"{n_warn} warning(s)")
    return 1 if analysis.has_errors(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
