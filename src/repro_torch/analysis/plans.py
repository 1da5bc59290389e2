"""Pass 3: the kernel-plan lint, block plans and generated source, statically.

``kernels/tuning.block_plans`` is the export surface the autotuner embeds in
calibrated-profile JSON; the kernel wrappers launch the plans the same
planners give. This pass re-derives every claim a plan makes from its tiles,
against a :class:`HardwareProfile` and the Hopper limits the CUDA launchers
enforce, so a plan that would not launch is rejected offline, without
compiling or launching a kernel:

  * each stage's shared memory, recomputed through ``tuning``'s own
    ``combine_smem`` (``combine_narrow_smem`` on Group Combine's narrow
    route), ``fused_f32_smem``, ``fused_tc_smem``, ``quant_combine_smem``
    and the tiled GEMM's ``tiled_wgmma_smem``, ``tiled_f32_smem`` and
    ``tiled_mma_smem`` (the report cross-checked), against
    min(plan budget, ``hw.vmem_bytes``): 232,448 B a block on ``h100_sxm``;
  * registers per thread (``combine_regs``, ``quant_combine_regs``,
    ``fused_f32_regs``, ``fused_tc_regs``) within ``REGS_PER_THREAD`` and a
    block's within an SM's ``REGS_PER_SM``;
  * threads per block within 1,024, grid y and z within 65,535 and x within
    2^31 - 1, as each launcher lays its grid out;
  * tensor-core tiles among ``TC_TILES``, f32 fused tiles among
    ``F32_TILES`` (with the stage depth Y calls for and the ring the kernel
    has), the tiled GEMM's ``wgmma`` tiles among ``TILED_WG_TILES`` and
    multiples of ``hw.mxu_align``, its ``f32`` and ``mma`` tiles among
    ``TILED_F32_TILES`` and ``TILED_MMA_TILES`` with registers within their
    launch bounds;
  * the int8 scale block dividing Y and a split's ranges covering its
    reduction units (tensor-core and f32 fused plans);
  * dtype legality per port backend (:data:`BACKEND_DTYPES`).

The reference lints VMEM footprints and MXU alignment of its Pallas plans;
here the budgets are the H100's.

The same pass lints the Deployment Module's generated source
(``core/codegen._emit_source``) at the AST level: the emitted combines are
machine-written Python, and the historical failure mode (coefficient
magnitudes silently dropped) is a generator bug, so the lint independently
re-checks the emitted linear combinations against the scheme's coefficient
tensors instead of trusting the emitter.
"""
from __future__ import annotations

import ast
import builtins

import numpy as np

from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.lcma import LCMA

from .findings import ERROR, WARNING, Finding

__all__ = ["lint_block_plan", "lint_tiled_plan", "lint_grouped_plan", "lint_scheme_plans",
           "lint_quant_plans", "lint_workload", "lint_codegen", "BACKEND_DTYPES",
           "MAX_GRID_X", "MAX_GRID_YZ", "MAX_THREADS"]

PASS = "plan-lint"
CODEGEN_PASS = "codegen-lint"

# Legal element dtypes per execution backend of the port. The CUDA kernels
# take f32 and bf16 operands and, on the quantized tier, int8 with f32
# scales; the generated "torch" backend runs any float dtype; the
# shard_map_local hook plans fp contractions only.
BACKEND_DTYPES = {
    "cuda": {"float32", "bfloat16", "int8"},
    "torch": {"float64", "float32", "bfloat16", "float16", "int8"},
    "shard_map_local": {"float32", "bfloat16"},
}

MAX_GRID_X = 2 ** 31 - 1     # gridDim.x
MAX_GRID_YZ = 65_535         # gridDim.y and gridDim.z
MAX_THREADS = 1_024          # threads per block

_REQUIRED = ("grid", "R", "padded_shape", "combine_a", "combine_b", "fused_gemm",
             "fused_gemm_tc", "quant_combine_a", "fused_gemm_quant",
             "combine_a_smem_bytes", "combine_b_smem_bytes", "fused_gemm_smem_bytes",
             "quant_combine_a_smem_bytes", "fused_gemm_tc_smem_bytes",
             "fused_gemm_quant_smem_bytes", "smem_budget_bytes")


def _itemsize(dtype: str) -> int:
    """Bytes of an element as ``tuning.block_plans`` sizes its plans."""
    return 2 if str(dtype) == "bfloat16" else 4


def _check_dtype(findings, subject, dtype, backend, what="dtype"):
    allowed = BACKEND_DTYPES.get(backend)
    if allowed is None:
        findings.append(Finding(PASS, WARNING, subject,
                                f"unknown backend {backend!r}: {what} legality not checked"))
        return True
    if str(dtype) not in allowed:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{what} {dtype} is not executable on backend {backend!r} "
                                f"(legal: {sorted(allowed)})"))
        return False
    return True


def _check_stage(findings, subject, stage, smem, reported, limit, hw, regs, threads, grid):
    """One kernel launch: its shared memory (recomputed ``smem`` against the
    ``reported`` values and ``limit``), registers a thread, threads a block
    and grid (x, y, z)."""
    for got in reported:
        if got is not None and int(got) != smem:
            findings.append(Finding(
                PASS, ERROR, subject,
                f"{stage} reports {int(got)} B of shared memory but its tiles imply "
                f"{smem} B (stale or hand-edited plan)"))
    if smem > limit:
        findings.append(Finding(
            PASS, ERROR, subject,
            f"{stage} shared memory {smem} B exceeds the "
            f"{'profile' if smem > hw.vmem_bytes else 'plan'} limit {limit} B "
            f"({hw.name}: {hw.vmem_bytes} B a block)"))
    from repro_torch.kernels import tuning
    if regs > tuning.REGS_PER_THREAD:
        findings.append(Finding(
            PASS, ERROR, subject,
            f"{stage} needs ~{regs} registers a thread > {tuning.REGS_PER_THREAD}"))
    elif regs * threads > tuning.REGS_PER_SM:
        findings.append(Finding(
            PASS, ERROR, subject,
            f"{stage} block needs ~{regs * threads} registers > an SM's "
            f"{tuning.REGS_PER_SM}"))
    if not 1 <= threads <= MAX_THREADS:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} block has {threads} threads (1..{MAX_THREADS})"))
    gx, gy, gz = grid
    if not (1 <= gx <= MAX_GRID_X and 1 <= gy <= MAX_GRID_YZ and 1 <= gz <= MAX_GRID_YZ):
        findings.append(Finding(
            PASS, ERROR, subject,
            f"{stage} grid ({gx}, {gy}, {gz}) is outside x <= {MAX_GRID_X}, "
            f"y, z <= {MAX_GRID_YZ}"))


def _check_tc(findings, subject, stage, p: dict, G, X, Y, Z, R, mn, quant, by, limit, hw,
              reported=()):
    """A tensor-core fused plan (bf16 or int8): tile, ring, units and
    splits, shared memory, registers and grid."""
    from repro_torch.kernels import tuning
    bx, bz = int(p["bx"]), int(p["bz"])
    if (bx, bz) not in tuning.TC_TILES:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} tile {bx}x{bz} is not a tensor-core tile "
                                f"{list(tuning.TC_TILES)}"))
        return
    if (int(p["bk"]), int(p["stages"])) != (tuning.TC_BK, tuning.TC_STAGES):
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} ring {p['stages']} x {p['bk']} is not the kernel's "
                                f"{tuning.TC_STAGES} x {tuning.TC_BK}"))
    if bool(p["acc_in_regs"]) != (mn <= tuning.TC_ACC_REGS):
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} keeps the {mn} output accumulators "
                                f"{'in registers' if p['acc_in_regs'] else 'in shared memory'}"
                                f"; the kernel does so only for m*n <= {tuning.TC_ACC_REGS}"))
    if quant:
        if by < 1 or Y % by:
            findings.append(Finding(PASS, ERROR, subject,
                                    f"{stage} scale block {by} does not divide Y = {Y}"))
            return
        units = R * (Y // by)
    else:
        units = R * -(-Y // tuning.TC_BK)
    splits = int(p["splits"])
    if int(p["units"]) != units:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} reduces {p['units']} units; R and Y give {units}"))
    _check_splits(findings, subject, stage, splits, units)
    smem = tuning.fused_tc_smem(bx, bz, mn, quant)
    regs = tuning.fused_tc_regs(bx, bz, mn, quant)
    grid = (-(-Z // bz), -(-X // bx), G * max(splits, 1))
    _check_stage(findings, subject, stage, smem, (p.get("smem_bytes"), *reported), limit, hw,
                 regs, tuning.TC_THREADS, grid)


def _check_splits(findings, subject, stage, splits, units):
    """``splits`` contiguous, non-empty ranges covering ``units`` steps."""
    from repro_torch.kernels import tuning
    ranges = tuning.split_ranges(units, splits) if splits >= 1 else []
    if not ranges or ranges[0][0] != 0 or ranges[-1][1] != units or \
            any(b >= e for b, e in ranges) or \
            any(ranges[i][1] != ranges[i + 1][0] for i in range(len(ranges) - 1)):
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage}: {splits} splits do not cover {units} units with "
                                f"non-empty contiguous ranges"))


def _check_f32(findings, subject, stage, p: dict, G, X, Y, Z, R, mn, limit, hw, reported=()):
    """An f32 fused plan: tile and micro-tile, stage depth and ring,
    accumulators, steps and splits, shared memory, registers and grid."""
    from repro_torch.kernels import tuning
    bx, bz, tm, bk = (int(p[k]) for k in ("bx", "bz", "tm", "bk"))
    if (bx, bz, tm) not in tuning.F32_TILES:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} tile {bx}x{bz} (tm {tm}) is not an f32 fused tile "
                                f"{list(tuning.F32_TILES)}"))
        return
    acc_regs = mn <= tuning.F32_ACC_REGS
    want_bk = tuning.fused_f32_bk(Y, tuning.fused_f32_pair(tm, acc_regs))
    if (bk, int(p["stages"])) != (want_bk, tuning.F32_STAGES):
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} ring {p['stages']} x {bk} is not the kernel's "
                                f"{tuning.F32_STAGES} x {want_bk} for Y = {Y}"))
    threads = tuning.fused_f32_threads(bx, bz, tm)
    if int(p["threads"]) != threads:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} names {p['threads']} threads; its tile has {threads}"))
    if bool(p["acc_in_regs"]) != acc_regs:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} keeps the {mn} output accumulators "
                                f"{'in registers' if p['acc_in_regs'] else 'in shared memory'}"
                                f"; the kernel does so only for m*n <= {tuning.F32_ACC_REGS}"))
    units = R * -(-Y // bk)
    if int(p["units"]) != units:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} reduces {p['units']} steps; R and Y give {units}"))
    splits = int(p["splits"])
    _check_splits(findings, subject, stage, splits, units)
    grid = (-(-Z // bz), -(-X // bx), G * max(splits, 1))
    _check_stage(findings, subject, stage, tuning.fused_f32_smem(bx, bz, tm, bk, mn, R),
                 (p.get("smem_bytes"), *reported), limit, hw, tuning.fused_f32_regs(tm, mn),
                 threads, grid)


def _check_combine(findings, subject, stage, p: dict, X, Y, coeff, isz, limit, hw,
                   reported=()):
    """A Group Combine plan for (d1*X, d2*Y) -> (R, X, Y) under ``coeff``."""
    from repro_torch.kernels import tuning
    R, d1, d2 = coeff.shape
    vec, ty, tx, rows = (int(p[k]) for k in ("vec", "ty", "tx", "rows"))
    table = R + 1 + 2 * int(np.count_nonzero(coeff))
    if p.get("route") == "narrow":
        # any Y: pieces of xb rows x yb columns (a multiple of 16 bytes where
        # yb cuts Y), 16-byte stores
        xb, yb = int(p["xb"]), int(p["yb"])
        if vec != 16 // isz or (tx, rows) != (1, 1) or xb < 1 or not (
                yb == Y or (0 < yb < Y and yb % vec == 0)):
            findings.append(Finding(PASS, ERROR, subject,
                                    f"{stage} narrow piece {xb} x {yb} (stores of {vec}) does "
                                    f"not tile the (X, Y) = ({X}, {Y}) plane"))
            return
        _check_stage(findings, subject, f"{stage}/narrow",
                     tuning.combine_narrow_smem(d1 * d2, xb, yb, table, isz),
                     (p.get("smem_bytes"), *reported), limit, hw, tuning.combine_regs(vec), ty,
                     (-(-X // xb), -(-Y // yb), 1))
        return
    if vec != 16 // isz or Y % vec:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} vector width {vec} does not tile Y = {Y} in "
                                f"16-byte accesses"))
        return
    smem = tuning.combine_smem(d1 * d2, ty * tx, table, 16)
    grid = (-(-(Y // vec) // ty), -(-X // (tx * rows)), 1)
    _check_stage(findings, subject, stage, smem, (p.get("smem_bytes"), *reported), limit, hw,
                 tuning.combine_regs(vec), ty * tx, grid)


def _check_quant_combine(findings, subject, p: dict, X, Y, coeff, isz, limit, hw, reported=()):
    from repro_torch.kernels import tuning
    R, d1, d2 = coeff.shape
    stage = "quant_combine_a"
    vec, by, lanes, splits, threads = (int(p[k]) for k in
                                       ("vec", "by", "lanes", "splits", "threads"))
    if by < 1 or Y % by:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage} scale block {by} does not divide Y = {Y}"))
        return
    if vec not in (1, 16 // isz) or by % vec or lanes < 1 or threads % lanes:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage}: vec {vec}, {lanes} lanes and {threads} threads do "
                                f"not tile a {by}-column K-block"))
        return
    if not 1 <= splits <= R:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{stage}: {splits} rank splits for R = {R}"))
    per_lane = -(-(by // vec) // lanes)
    table = R + 1 + 2 * int(np.count_nonzero(coeff))
    smem = tuning.quant_combine_smem(d1 * d2, per_lane, threads, table, vec * isz)
    units = X * (Y // by)
    grid = (-(-units // (threads // lanes)), 1, max(splits, 1))
    _check_stage(findings, subject, stage, smem, (p.get("smem_bytes"), *reported), limit, hw,
                 tuning.quant_combine_regs(vec), threads, grid)


def lint_block_plan(plan: dict, hw: HardwareProfile, *, scheme: LCMA | None = None,
                    dtype: str = "float32", backend: str = "cuda",
                    subject: str | None = None) -> list[Finding]:
    """Statically check one ``tuning.block_plans`` dict against a hardware
    profile (module docstring). The combines' shared memory depends on the
    scheme's coefficients (its parts and CSR table), which the plan does not
    name: pass ``scheme``, else the plan is checked against every library
    scheme of its grid and R and passes if one of them explains it."""
    subject = subject or f"plan<{plan.get('grid')};R={plan.get('R')}>"
    missing = [k for k in _REQUIRED if k not in plan]
    if missing:
        return [Finding(PASS, ERROR, subject, f"malformed plan: missing keys {missing}")]
    if scheme is not None:
        return _lint_plan(plan, scheme, hw, dtype, backend, subject, [])
    from repro_torch.core import algorithms
    key = (*(int(x) for x in plan["grid"]), int(plan["R"]))
    schemes = [l for l in algorithms.library().values() if (l.m, l.k, l.n, l.R) == key]
    if not schemes:
        return [Finding(PASS, ERROR, subject,
                        f"no library scheme has grid {key[:3]} and R = {key[3]}")]
    results = [_lint_plan(plan, l, hw, dtype, backend, subject, []) for l in schemes]
    return next((f for f in results if not any(x.is_error for x in f)), results[0])


def _lint_plan(plan, l: LCMA, hw, dtype, backend, subject, findings):
    from repro_torch.kernels import tuning
    _check_dtype(findings, subject, dtype, backend)
    m, k, n = (int(x) for x in plan["grid"])
    R = int(plan["R"])
    if (m, k, n, R) != (l.m, l.k, l.n, l.R):
        findings.append(Finding(PASS, ERROR, subject,
                                f"plan grid {m}x{k}x{n};R={R} is not scheme {l.name}'s "
                                f"{l.m}x{l.k}x{l.n};R={l.R}"))
        return findings
    Mp, Kp, Np = (int(x) for x in plan["padded_shape"])
    for name, dim, g in (("M", Mp, m), ("K", Kp, k), ("N", Np, n)):
        if dim % g:
            findings.append(Finding(PASS, ERROR, subject,
                                    f"padded {name}={dim} is not divisible by grid {g}"))
    if any(f.is_error for f in findings):
        return findings
    X, Y, Z = Mp // m, Kp // k, Np // n
    isz = _itemsize(dtype)
    limit = min(int(plan["smem_budget_bytes"]), int(hw.vmem_bytes))
    _check_combine(findings, subject, "combine_a", plan["combine_a"], X, Y, l.U, isz, limit,
                   hw, (plan["combine_a_smem_bytes"],))
    _check_combine(findings, subject, "combine_b", plan["combine_b"], Y, Z, l.V, isz, limit,
                   hw, (plan["combine_b_smem_bytes"],))
    _check_f32(findings, subject, "fused_gemm", plan["fused_gemm"], 1, X, Y, Z, R, m * n,
               limit, hw, (plan["fused_gemm_smem_bytes"],))
    _check_tc(findings, subject, "fused_gemm_tc", plan["fused_gemm_tc"], 1, X, Y, Z, R, m * n,
              False, None, limit, hw, (plan["fused_gemm_tc_smem_bytes"],))
    by = tuning.scale_block(Y)
    q = plan["quant_combine_a"]
    if int(q["by"]) != by:
        findings.append(Finding(PASS, ERROR, subject,
                                f"quant_combine_a scale block {q['by']} is not the weight's "
                                f"{by} (the largest divisor of Y = {Y} up to 128)"))
    _check_quant_combine(findings, subject, q, X, Y, l.U, isz, limit, hw,
                         (plan["quant_combine_a_smem_bytes"],))
    _check_tc(findings, subject, "fused_gemm_quant", plan["fused_gemm_quant"], 1, X, Y, Z, R,
              m * n, True, int(q["by"]), limit, hw, (plan["fused_gemm_quant_smem_bytes"],))
    return findings


def lint_tiled_plan(M: int, K: int, N: int, hw: HardwareProfile, *,
                    dtype: str = "bfloat16", subject: str | None = None) -> list[Finding]:
    """The tiled GEMM a plain (GEMM-decided) contraction launches, on the
    route ``tuning.tiled_route`` gives aligned operands: the ``wgmma`` plan
    for bf16 that TMA can address (tile among ``TILED_WG_TILES`` and a
    multiple of ``hw.mxu_align``), the ``mma`` plan for other bf16 (tile
    among ``TILED_MMA_TILES``), the ``f32`` plan for f32 (tile among
    ``TILED_F32_TILES``, registers within its launch bounds); each with its
    shared memory, threads, grid and splits."""
    from repro_torch.kernels import tuning
    subject = subject or f"tiled@{M}x{K}x{N}/{dtype}"
    findings: list[Finding] = []
    limit = min(tuning.SMEM_BUDGET, int(hw.vmem_bytes))
    route = tuning.tiled_route(str(dtype), K, N, 0, 0)
    if route == "wgmma":
        p = tuning.plan_tiled_wgmma(M, K, N)
        if (p.bm, p.bn) not in tuning.TILED_WG_TILES:
            findings.append(Finding(PASS, ERROR, subject,
                                    f"wgmma tile {p.bm}x{p.bn} is not among "
                                    f"{list(tuning.TILED_WG_TILES)}"))
        if p.bm % hw.mxu_align or p.bn % hw.mxu_align:
            findings.append(Finding(PASS, ERROR, subject,
                                    f"wgmma tile {p.bm}x{p.bn} is not a multiple of "
                                    f"{hw.name}'s {hw.mxu_align}-row tile"))
        _check_stage(findings, subject, "tiled_wgmma", tuning.tiled_wgmma_smem(p.bm, p.bn),
                     (p.smem_bytes,), limit, hw, tuning.tiled_wgmma_regs(p.bn),
                     tuning.tiled_wgmma_threads(p.bm),
                     (-(-N // p.bn), -(-M // p.bm), p.splits))
        return findings
    if route == "f32":
        p = tuning.plan_tiled_f32(M, K, N, vec=N % 4 == 0)
        tiles, smem = tuning.TILED_F32_TILES, tuning.tiled_f32_smem(p.bm, p.bn)
        min_blocks = tiles.get((p.bm, p.bn), (0,) * 5)[4]
    else:
        p = tuning.plan_tiled_mma(M, K, N, vec_a=K % 8 == 0, vec_b=N % 8 == 0)
        tiles, smem = tuning.TILED_MMA_TILES, tuning.tiled_mma_smem(p.bm)
        min_blocks = tuning.TILED_MMA_MIN_BLOCKS
    if (p.bm, p.bn) not in tiles:
        findings.append(Finding(PASS, ERROR, subject,
                                f"{route} tile {p.bm}x{p.bn} is not among {list(tiles)}"))
        return findings
    cap = min(tuning.REGS_PER_THREAD, tuning.REGS_PER_SM // (p.threads * min_blocks))
    if p.regs > cap:
        findings.append(Finding(PASS, ERROR, subject,
                                f"tiled_{route} needs ~{p.regs} registers a thread > the "
                                f"{cap} its launch bounds ({min_blocks} blocks an SM) allow"))
    _check_stage(findings, subject, f"tiled_{route}", smem, (p.smem_bytes,), limit, hw, p.regs,
                 p.threads, (-(-N // p.bn), -(-M // p.bm), p.splits))
    return findings


def lint_grouped_plan(l: LCMA, G: int, M: int, K: int, N: int, hw: HardwareProfile, *,
                      shared_b: bool = False, dtype: str = "bfloat16",
                      subject: str | None = None) -> list[Finding]:
    """A grouped contraction's fused plan: the tensor-core one
    (``plan_fused_tc(G, ...)``) for bf16, the f32 one (``plan_fused_f32(G,
    ...)``) for float32 (the SSD contractions); G groups ride blockIdx.z
    with the splits."""
    from repro_torch.kernels import tuning
    subject = subject or f"{l.name}@g{G}x{M}x{K}x{N}/{dtype}"
    findings: list[Finding] = []
    X, Y, Z = -(-M // l.m), -(-K // l.k), -(-N // l.n)
    limit = min(tuning.SMEM_BUDGET, int(hw.vmem_bytes))
    f32 = str(dtype) == "float32"
    plan = tuning.plan_fused_f32 if f32 else tuning.plan_fused_tc
    try:
        p = plan(G, X, Y, Z, l.R, l.m, l.n, shared_b=shared_b, budget=limit)
    except ValueError as e:
        return [Finding(PASS, ERROR, subject, f"no grouped fused plan: {e}")]
    if f32:
        _check_f32(findings, subject, "grouped fused_gemm", p.as_dict(), G, X, Y, Z, l.R,
                   l.m * l.n, limit, hw)
    else:
        _check_tc(findings, subject, "grouped fused_gemm_tc", p.as_dict(), G, X, Y, Z, l.R,
                  l.m * l.n, False, None, limit, hw)
    return findings


def lint_scheme_plans(l: LCMA, shapes, hw: HardwareProfile, *,
                      dtype: str = "float32", backend: str = "cuda") -> list[Finding]:
    """Generate and lint the block plans scheme ``l`` would use on ``shapes``."""
    from repro_torch.kernels import tuning
    findings: list[Finding] = []
    for (M, K, N) in shapes:
        subject = f"{l.name}@{M}x{K}x{N}/{dtype}"
        try:
            plan = tuning.block_plans(l, M, K, N, dtype=dtype, hw=hw)
        except ValueError as e:
            findings.append(Finding(PASS, ERROR, subject, f"no plan fits: {e}"))
            continue
        findings.extend(lint_block_plan(plan, hw, scheme=l, dtype=dtype, backend=backend,
                                        subject=subject))
    return findings


def lint_quant_plans(l: LCMA, shapes, hw: HardwareProfile, *,
                     backend: str = "cuda", dtype: str = "bfloat16",
                     acc_bits: int = 32) -> list[Finding]:
    """Statically lint the int8-quantized pipeline ``l`` would run on ``shapes``.

    Re-derives, for each serving shape, the choices the quantized
    PlannedWeight path makes: the weight scale block ``by``
    (``tuning.scale_block``: the largest divisor of the combined K up to
    128), the quant Group Combine A plan and the int8 tensor-core fused
    plan, then checks:

    * **backend legality**: int8 operands must be executable on ``backend``
      (``shard_map_local`` has no quant path);
    * **accumulator safety**: a ``by``-deep int8*int8 reduction must fit the
      int-``acc_bits`` accumulator (``stability.max_safe_accum_depth``);
    * **scale-block divisibility and both kernels' plans** (shared memory,
      registers, threads, grid, units and splits), as the launchers check
      them;
    * **degenerate scale blocks** (warning): a ``by`` far below the 128 cap
      means the combined K is oddly factored and the per-block scale
      arrays bloat the traffic the decision tier priced.
    """
    from repro_torch.analysis.stability import int8_accum_bound, max_safe_accum_depth
    from repro_torch.kernels import tuning

    findings: list[Finding] = []
    safe_depth = max_safe_accum_depth(acc_bits)
    limit = min(tuning.SMEM_BUDGET, int(hw.vmem_bytes))
    for (M, K, N) in shapes:
        subject = f"{l.name}@{M}x{K}x{N}/int8"
        if not _check_dtype(findings, subject, "int8", backend, what="int8"):
            continue
        X, Y, Z = -(-M // l.m), -(-K // l.k), -(-N // l.n)
        by = tuning.scale_block(Y)
        if Y % by:
            findings.append(Finding(PASS, ERROR, subject,
                                    f"quant scale block {by} does not divide K/k = {Y}"))
            continue
        if by > safe_depth:
            findings.append(Finding(
                PASS, ERROR, subject,
                f"int8 reduction depth {by} can overflow the int{acc_bits} "
                f"accumulator: worst-case |sum| = {int8_accum_bound(by)} > "
                f"{2 ** (acc_bits - 1) - 1} (max safe depth {safe_depth})"))
        isz = _itemsize(dtype)
        try:
            qc = tuning.plan_quant_combine(X, Y, l.U, isz, by, budget=limit)
            fq = tuning.plan_fused_tc(1, X, Y, Z, l.R, l.m, l.n, by=by, budget=limit)
        except ValueError as e:
            findings.append(Finding(PASS, ERROR, subject, f"no quant plan fits: {e}"))
            continue
        _check_quant_combine(findings, subject, qc.as_dict(), X, Y, l.U, isz, limit, hw)
        _check_tc(findings, subject, "fused_gemm_quant", fq.as_dict(), 1, X, Y, Z, l.R,
                  l.m * l.n, True, by, limit, hw)
        if Y >= 32 and by < 32:
            findings.append(Finding(
                PASS, WARNING, subject,
                f"quant scale block snaps to {by} (combined K {Y} has no "
                f"divisor in [32, 128]): scale arrays are {Y // by}x larger "
                f"than the 128-block baseline the decision tier prices"))
    return findings


def lint_workload(arch, hw: HardwareProfile, *, batch: int = 8, seq: int = 512,
                  dtype: str | None = None, backend: str = "cuda", train: bool = False,
                  quantize: bool = False, mesh_shape=None,
                  all_candidates: bool = False) -> list[Finding]:
    """Statically lint an architecture's full contraction set against ``hw``.

    The workload registry (``core.workloads``) enumerates every planned
    contraction ``arch`` issues at (batch, seq); for each unique shape the
    Decision Module picks its scheme (``decide``, or ``decide_batched`` for
    a grouped contraction) and that scheme's plans are linted: the block
    plans of a 2-D contraction, the grouped fused plan of a grouped one
    (``lint_grouped_plan``), and the tiled GEMM of a contraction the
    decision leaves on GEMM. The SSD contractions run in float32 whatever
    ``dtype`` is (``workloads.F32_KINDS``), so they are decided and linted
    in float32. ``all_candidates=True`` lints
    every candidate scheme per shape instead (a scheme the decision would
    never pick may legitimately fail there: triage, not CI gating). With
    ``quantize=True`` the int8 pipeline of each weight-static 2-D
    contraction is linted too. ``arch`` is a registry id or a
    ``ModelConfig``.
    """
    from repro_torch.core import algorithms, decision
    from repro_torch.core.workloads import F32_KINDS, _resolve_arch, resolve_contractions

    cfg = _resolve_arch(arch)
    name = getattr(cfg, "name", str(arch))
    dtype = str(dtype or getattr(cfg, "dtype", "bfloat16"))
    findings: list[Finding] = []
    for c in resolve_contractions(arch, batch, seq, train=train, mesh_shape=mesh_shape):
        if quantize and not (c.weight_static and c.kind in ("dense", "grouped_moe")):
            continue
        m, k, n = c.shape
        grouped = c.group != 1
        cdt = "float32" if c.kind in F32_KINDS else dtype
        if all_candidates:
            schemes = list(algorithms.candidates())
        elif grouped:
            d = decision.decide_batched(c.group, m, n, k, hw, cdt, shared_b=c.shared_b)
            schemes = [d.algo] if d.use_lcma else []
        else:
            d = decision.decide(m, n, k, hw, cdt)
            schemes = [d.algo] if d.use_lcma else []
        where = f"{name}:{c.role}"
        if not schemes and not grouped:
            findings.extend(lint_tiled_plan(m, k, n, hw, dtype=cdt,
                                            subject=f"{where}:gemm@{m}x{k}x{n}/{cdt}"))
        for l in schemes:
            if grouped:
                findings.extend(lint_grouped_plan(
                    l, c.group, m, k, n, hw, shared_b=c.shared_b, dtype=cdt,
                    subject=f"{where}:{l.name}@g{c.group}x{m}x{k}x{n}/{cdt}"))
                continue
            subject = f"{where}:{l.name}@{m}x{k}x{n}/{cdt}"
            for f in lint_scheme_plans(l, [(m, k, n)], hw, dtype=cdt, backend=backend):
                findings.append(Finding(f.pass_name, f.severity, subject, f.message))
            if quantize:
                findings.extend(lint_quant_plans(l, [(m, k, n)], hw, backend=backend,
                                                 dtype=cdt))
    return findings


# ---------------------------------------------------------------------------
# Codegen AST lint
# ---------------------------------------------------------------------------

_ALLOWED_GLOBALS = {"torch", "product"} | set(dir(builtins))

_REQUIRED_FUNCS = ("combine_a", "combine_b", "gemm_stage", "combine_h", "lcma_matmul")


class _FuncScope(ast.NodeVisitor):
    """Collect assigned and loaded names within one function body."""

    def __init__(self):
        self.stored: set[str] = set()
        self.loaded: list[tuple[str, int]] = []

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Store):
            self.stored.add(node.id)
        elif isinstance(node.ctx, ast.Load):
            self.loaded.append((node.id, node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):  # nested defs: opaque
        self.stored.add(node.name)


def _is_zero(e: ast.expr) -> bool:
    """The emitter's empty sum: ``torch.zeros_like(...)``."""
    return isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
        and e.func.attr == "zeros_like" and isinstance(e.func.value, ast.Name) \
        and e.func.value.id == "torch"


def _coeff_from_expr(expr: ast.expr, var_coeff: dict) -> None:
    """Accumulate ``{name: coeff}`` from an emitted linear combination.

    The emitter's grammar is tiny: sums/differences of ``name``,
    ``const * name``, unary minus and the empty sum. Anything outside that
    grammar raises ``ValueError``, which the caller reports as a lint error.
    """
    def term(e, sign):
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            term(e.operand, -sign)
        elif isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
            term(e.left, sign)
            term(e.right, sign)
        elif isinstance(e, ast.BinOp) and isinstance(e.op, ast.Sub):
            term(e.left, sign)
            term(e.right, -sign)
        elif isinstance(e, ast.BinOp) and isinstance(e.op, ast.Mult):
            try:  # literal_eval also accepts a negated constant (-3 * x)
                c = ast.literal_eval(e.left)
            except ValueError:
                raise ValueError(f"non-constant scale {ast.dump(e.left)}") from None
            name = _name_of(e.right)
            var_coeff[name] = var_coeff.get(name, 0) + sign * c
        elif _is_zero(e):
            pass
        else:
            name = _name_of(e)
            var_coeff[name] = var_coeff.get(name, 0) + sign
    term(expr, 1)


def _rank_of(e: ast.Subscript):
    """r of ``H[..., r, :, :]``, else None."""
    s = e.slice
    if isinstance(s, ast.Tuple) and len(s.elts) == 4 and isinstance(s.elts[1], ast.Constant) \
            and isinstance(s.elts[0], ast.Constant) and s.elts[0].value is Ellipsis:
        return s.elts[1].value
    return None


def _name_of(e: ast.expr) -> str:
    if isinstance(e, ast.Name):
        return e.id
    if isinstance(e, ast.Subscript) and isinstance(e.value, ast.Name):
        r = _rank_of(e)
        if r is not None:
            return f"{e.value.id}[{r}]"
    raise ValueError(f"unexpected term {ast.dump(e)}")


def _expected_combine(coeff: np.ndarray, part: str, r: int) -> dict:
    d1, d2 = coeff.shape[1], coeff.shape[2]
    return {f"{part}_{i}_{l}": int(coeff[r, i, l])
            for i in range(d1) for l in range(d2) if coeff[r, i, l] != 0}


def lint_codegen(l: LCMA, options=None) -> list[Finding]:
    """AST-level checks on the source ``codegen._emit_source`` emits for ``l``.

    * the source parses and defines the full stage surface;
    * no function loads a name that is neither assigned locally, a
      parameter, a module-level def, nor an allowed global (``torch``,
      ``product``, builtins): the "sliced a_0_3 that was never emitted"
      class of generator bug;
    * every ``at_r = ...`` / ``bt_r = ...`` combine is parsed back into its
      ``{operand: coefficient}`` map and compared exactly against U/V: a
      re-derivation, not a trust of the emitter (a magnitude-dropping bug is
      invisible to name-scope checks but caught here);
    * Combine H's ``H[..., r, :, :]`` subscripts stay within rank bounds and
      its coefficient map matches W.
    """
    from repro_torch.core import codegen

    o = options or codegen.CodegenOptions()
    src = codegen._emit_source(l, o)
    subject = f"codegen:{l.name}"
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(CODEGEN_PASS, ERROR, subject, f"emitted source does not parse: {e}")]
    findings: list[Finding] = []

    funcs = {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}
    for name in _REQUIRED_FUNCS:
        if name not in funcs:
            findings.append(Finding(CODEGEN_PASS, ERROR, subject,
                                    f"generated source lacks def {name}()"))
    module_names = set(funcs) | _ALLOWED_GLOBALS

    for fname, node in funcs.items():
        scope = _FuncScope()
        for stmt in node.body:
            scope.visit(stmt)
        known = scope.stored | {a.arg for a in node.args.args} | module_names
        for name, lineno in scope.loaded:
            if name not in known:
                findings.append(Finding(
                    CODEGEN_PASS, ERROR, subject,
                    f"{fname}() line {lineno}: loads undefined name {name!r}"))

    # Re-derive the combine coefficient maps from the AST.
    for fname, coeff, part, out in (("combine_a", l.U, "a", "at"),
                                    ("combine_b", l.V, "b", "bt")):
        node = funcs.get(fname)
        if node is None:
            continue
        got: dict[int, dict] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id.startswith(out + "_"):
                tgt = stmt.targets[0].id
                terms: dict = {}
                try:
                    _coeff_from_expr(stmt.value, terms)
                except ValueError as e:
                    findings.append(Finding(CODEGEN_PASS, ERROR, subject,
                                            f"{fname}() {tgt}: unparseable combine ({e})"))
                    continue
                got[int(tgt[len(out) + 1:])] = {k: v for k, v in terms.items() if v != 0}
        if set(got) != set(range(l.R)):
            findings.append(Finding(CODEGEN_PASS, ERROR, subject,
                                    f"{fname}() emits combines for ranks {sorted(got)}; "
                                    f"expected 0..{l.R - 1}"))
        for r, terms in got.items():
            want = _expected_combine(coeff, part, r)
            if terms != want:
                findings.append(Finding(CODEGEN_PASS, ERROR, subject,
                                        f"{fname}() rank {r}: emitted coefficients {terms} "
                                        f"!= scheme tensor {want}"))

    # Combine H: subscript bounds + coefficient map vs W.
    node = funcs.get("combine_h")
    if node is not None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name) \
                    and sub.value.id == "H":
                r = _rank_of(sub)
                if r is not None and not (0 <= r < l.R):
                    findings.append(Finding(CODEGEN_PASS, ERROR, subject,
                                            f"combine_h() indexes H[..., {r}] outside rank "
                                            f"0..{l.R - 1}"))
        got_h: dict[tuple[int, int], dict] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id.startswith("c_"):
                _, i, j = stmt.targets[0].id.split("_")
                expr = stmt.value
                # strip the trailing (...).to(out_dtype) call
                if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
                        and expr.func.attr == "to":
                    expr = expr.func.value
                terms = {}
                try:
                    _coeff_from_expr(expr, terms)
                except ValueError as e:
                    findings.append(Finding(CODEGEN_PASS, ERROR, subject,
                                            f"combine_h() c_{i}_{j}: unparseable combine ({e})"))
                    continue
                got_h[(int(i), int(j))] = {k: v for k, v in terms.items() if v != 0}
        for i in range(l.m):
            for j in range(l.n):
                want = {f"H[{r}]": int(l.W[r, i, j]) for r in range(l.R) if l.W[r, i, j] != 0}
                if got_h.get((i, j), {}) != want:
                    findings.append(Finding(CODEGEN_PASS, ERROR, subject,
                                            f"combine_h() C[{i},{j}]: emitted "
                                            f"{got_h.get((i, j))} != scheme W column {want}"))
    return findings
