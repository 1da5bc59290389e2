"""Guards of the PyTorch port: what it imports, where it runs, how it fails.

The port imports torch and numpy and nothing of JAX or of the reference
package; its entry points run on the card unless the caller asks for the
CPU, and on a machine without a card they fail instead of falling back.
"""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import algorithms as talg
from repro_torch.kernels import build, ref

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))


def _modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_port_imports_no_jax_and_nothing_of_the_reference():
    mods = _modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_no_reference_or_jax_import_statement():
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f}: {m.group(0).strip()}" for f in files
                 for m in IMPORT.finditer(f.read_text())]
    assert offenders == []


def test_launcher_runs_on_cpu_when_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"],
        capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "sample:" in out.stdout


def test_launcher_quant_runs_on_cpu_when_asked():
    """``--quant`` on the CPU: the int8 tier is priced, planned leaves carry
    int8 B̃q, and the kernels' plain versions serve."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3", "--quant"],
        capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr
    n = re.search(r"(\d+) weight tensor\(s\) precombined into PlannedWeights, (\d+) with "
                  r"int8", out.stdout)
    assert n and int(n.group(2)) == int(n.group(1)) > 0, out.stdout
    assert "sample:" in out.stdout


def test_launcher_continuous_runs_on_cpu_when_asked():
    """``--continuous`` on the CPU: 8 ragged requests through the engine,
    every step a warmed bucket (the steps run eagerly: graphs are the
    card's), with the reference launcher's summary lines."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
         "--device", "cpu", "--continuous", "--requests", "8"],
        capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr
    for line in ("engine: 8 slots", "warmup:", "served 8/8 requests", "bucket hit rate 100.0%",
                 "plan cache:", "sample (rid="):
        assert line in out.stdout, out.stdout
    assert "0 CUDA graphs" in out.stdout


def test_launcher_layers_cuts_only_the_depth(monkeypatch, capsys):
    """``--layers N`` serves the arch's config with N layers and every other
    field as it was (here dbrx's smoke config on the CPU)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve

    served = []

    def recording(cfg, **kw):
        served.append(cfg)
        return run(cfg, **kw)

    run = serve.run_oneshot
    monkeypatch.setattr(serve, "run_oneshot", recording)
    serve.main(["--arch", "dbrx_132b", "--layers", "1", "--device", "cpu", "--batch", "1",
                "--prompt-len", "8", "--gen", "2"])
    want = smoke_config("dbrx_132b")
    assert want.num_layers > 1
    assert served == [dataclasses.replace(want, num_layers=1)]
    assert "sample:" in capsys.readouterr().out


def test_continuous_launcher_without_device_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
         "--continuous", "--requests", "2"], capture_output=True, text=True, env=ENV,
        timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_launcher_without_device_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite_3_2b",
         "--gen", "2"], capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("fused_gemm")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "kernels").exists()


def test_library_name_follows_the_sources():
    paths = {name: build._lib_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR and path.name.startswith(name + "-")
    assert build.BUILD_DIR == REPO / "build" / "kernels"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_ptxas_report_reads_the_build_log(tmp_path, monkeypatch):
    """Registers, static shared memory and spills of each kernel, as
    ``-Xptxas -v`` printed them into the log kept beside the library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert "-v" in build.NVCC_FLAGS and build.ptxas_report("tiled_matmul") == []
    build._lib_path("tiled_matmul").with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_Z3fooi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooi\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 154 registers, used 1 barriers, 5184 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 0 barriers\n")
    assert build.ptxas_report("tiled_matmul") == [
        {"kernel": "_Z3fooi", "spill_stores": 8, "spill_loads": 4, "registers": 154,
         "smem": 5184},
        {"kernel": "_Z3barv", "spill_stores": 0, "spill_loads": 0, "registers": 32,
         "smem": 0}]
    assert build.ptxas_report("group_combine") == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


# Run on a machine with a card (no JAX there): python -m pytest -q -m cuda
# tests/test_torch_serve.py
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["strassen", "s555"])
def test_cuda_kernels_match_plain_versions(name, cuda_device, rng):
    tl = talg.get(name)
    x = torch.tensor(rng.standard_normal((tl.m * 37, tl.k * 53)), dtype=torch.float32)
    got = K.group_combine(x.to(cuda_device), tl.U).cpu()
    torch.testing.assert_close(got, K.group_combine(x, tl.U), atol=1e-5, rtol=1e-6)
    at = torch.tensor(rng.standard_normal((2, tl.R, 19, 23)), dtype=torch.float32)
    bt = torch.tensor(rng.standard_normal((tl.R, 23, 21)), dtype=torch.float32)
    got = K.batched_fused_gemm_combine_h(at.to(cuda_device), bt.to(cuda_device), tl.W)
    torch.testing.assert_close(got.cpu(), K.batched_fused_gemm_combine_h(at, bt, tl.W),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["strassen", "laderman"])
def test_cuda_quant_kernels_match_plain_versions(name, cuda_device, rng):
    """The quant Group Combine on each route, bit-equal to its plain version
    on the CPU: ragged f32 (by = 25, scalar), bf16 at granite's K-block (by
    = 128, the vector route) and the same from a view whose pointer is not
    16-byte aligned (scalar); each call's route counted by the wrapper.
    Then the int8 fused kernel on the ragged case's operands."""
    from repro_torch.kernels.quant_combine import launch_plan
    tl = talg.get(name)
    xb = torch.tensor(rng.standard_normal((tl.m * 6, tl.k * 1024)), dtype=torch.float32)
    shifted = torch.empty(xb.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    shifted = shifted.view(xb.shape)
    shifted.copy_(xb.to(torch.bfloat16))
    for xc, by, route in ((xb.to(torch.bfloat16).to(cuda_device), 128, "vector"),
                          (shifted, 128, "scalar")):
        assert launch_plan(xc, tl.U, by).route == route
        before = dict(K.group_combine_quant.routes)
        q, s = K.group_combine_quant(xc, tl.U, by)
        assert K.group_combine_quant.routes[route] == before[route] + 1
        q0, s0 = K.group_combine_quant(xc.cpu(), tl.U, by)
        assert torch.equal(q.cpu(), q0) and torch.equal(s.cpu(), s0)
    x = torch.tensor(rng.standard_normal((tl.m * 37, tl.k * 75)), dtype=torch.float32)
    before = dict(K.group_combine_quant.routes)
    q, s = K.group_combine_quant(x.to(cuda_device), tl.U, 25)
    assert K.group_combine_quant.routes["scalar"] == before["scalar"] + 1
    q0, s0 = K.group_combine_quant(x, tl.U, 25)
    assert torch.equal(q.cpu(), q0) and torch.equal(s.cpu(), s0)
    before = K.fused_gemm_combine_h_quant.launches
    got = K.fused_gemm_combine_h_quant(q, s, q.transpose(1, 2).contiguous(),
                                       s.transpose(1, 2).contiguous(), tl.W)
    assert K.fused_gemm_combine_h_quant.launches == before + 1
    want = K.fused_gemm_combine_h_quant(q0, s0, q0.transpose(1, 2).contiguous(),
                                        s0.transpose(1, 2).contiguous(), tl.W)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 23, 17), (256, 512, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_matmul_matches_plain_version(shape, dtype, cuda_device, rng):
    """Ragged (f32: the SGEMM's 4-byte copies; bf16: the mma.sync route's
    raw rows, masked edges) and aligned (f32: the SGEMM's 16-byte copies;
    bf16: the wgmma route) against the plain version on the CPU: f32 sums
    in another order; in bf16 both round an f32 sum once, so they differ by
    one bf16 ulp at most."""
    M, K_, N = shape
    a = torch.tensor(rng.standard_normal((M, K_)), dtype=torch.float32).to(dtype)
    b = torch.tensor(rng.standard_normal((K_, N)), dtype=torch.float32).to(dtype)
    before = K.tiled_matmul.launches
    got = K.tiled_matmul(a.to(cuda_device), b.to(cuda_device))
    assert K.tiled_matmul.launches == before + 1
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-3, rtol=1e-2)
    torch.testing.assert_close(got.cpu().float(), K.tiled_matmul(a, b).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["strassen", "laderman"])
def test_cuda_fused_kernels_split_at_decode(name, cuda_device, rng):
    """Decode rows (X = 2), where the planner splits the (rank, K) reduction
    across blocks (S > 1) and a second pass sums the partials in fixed
    order: the bf16 and the int8 tensor-core kernels against their plain
    versions on the CPU. bf16: both round an f32 sum once (one bf16 ulp);
    int8: exact int32 K-block sums, f32 dequantize and Combine H in another
    order of the partial sums."""
    from repro_torch.kernels import tuning
    tl = talg.get(name)
    X, Y, Z, by = 2, 512, 1024, 128
    assert tuning.plan_fused_tc(1, X, Y, Z, tl.R, tl.m, tl.n).splits > 1
    assert tuning.plan_fused_tc(1, X, Y, Z, tl.R, tl.m, tl.n, by=by).splits > 1
    at = torch.tensor(rng.standard_normal((tl.R, X, Y)), dtype=torch.float32).bfloat16()
    bt = torch.tensor(rng.standard_normal((tl.R, Y, Z)), dtype=torch.float32).bfloat16()
    before = K.fused_gemm_combine_h.launches
    got = K.fused_gemm_combine_h(at.to(cuda_device), bt.to(cuda_device), tl.W)
    assert K.fused_gemm_combine_h.launches == before + 1
    torch.testing.assert_close(got.cpu().float(), K.fused_gemm_combine_h(at, bt, tl.W).float(),
                               atol=1e-2, rtol=1e-2)
    aq = torch.tensor(rng.integers(-127, 128, (tl.R, X, Y)), dtype=torch.int8)
    bq = torch.tensor(rng.integers(-127, 128, (tl.R, Y, Z)), dtype=torch.int8)
    a_s = torch.tensor(rng.uniform(1e-3, 2e-2, (tl.R, X, Y // by)), dtype=torch.float32)
    b_s = torch.tensor(rng.uniform(1e-3, 2e-2, (tl.R, Y // by, Z)), dtype=torch.float32)
    before = K.fused_gemm_combine_h_quant.launches
    got = K.fused_gemm_combine_h_quant(*(t.to(cuda_device) for t in (aq, a_s, bq, b_s)), tl.W)
    assert K.fused_gemm_combine_h_quant.launches == before + 1
    want = K.fused_gemm_combine_h_quant(aq, a_s, bq, b_s, tl.W)
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got.cpu(), want, atol=1e-5 * scale, rtol=1e-5)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error normalized by max(1, max|want|), as chip_smoke.py's."""
    d = (got.float() - want.float()).abs().max().item()
    return d / max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("mkn,route", [
    ((256, 2048, 8192), "wgmma"), ((256, 8192, 2048), "wgmma"),   # the tune probes
    ((4096, 4096, 4096), "wgmma"), ((4, 2048, 8192), "wgmma"),    # ... and decode rows
    ((13, 23, 17), "mma"),                                        # ragged: no TMA
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_cuda_tiled_matmul_routes(mkn, route, cuda_device):
    """bf16 at the tune probes and decode rows on the tensor-core route (the
    second probe and the decode rows split K across blocks), a ragged shape
    on the mma.sync route; each against the plain version on the card,
    within one bf16 ulp of the largest value."""
    M, K_, N = mkn
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(M, K_, device=cuda_device, generator=gen).bfloat16()
    b = torch.randn(K_, N, device=cuda_device, generator=gen).bfloat16()
    before = dict(K.tiled_matmul.routes)
    got = K.tiled_matmul(a, b)
    assert {r: K.tiled_matmul.routes[r] - before[r] for r in before} == \
        {r: int(r == route) for r in before}
    want = ref.tiled_matmul_ref(a, b)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(4096, 4096, 4096), (256, 2048, 8192), (256, 8192, 2048),
                                 (4, 2048, 8192), (13, 23, 17)],
                         ids=lambda v: "x".join(map(str, v)))
def test_cuda_tiled_matmul_f32_and_mma_routes(mkn, cuda_device):
    """f32 at the tune probes, decode rows and a ragged shape on the FP32
    SGEMM (the same f32 sums in another order: 1e-4), and bf16 from a
    misaligned A on the mma.sync route (one bf16 ulp), against the plain
    version on the card; each call's route counted."""
    M, K_, N = mkn
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn(M, K_, device=cuda_device, generator=gen)
    b = torch.randn(K_, N, device=cuda_device, generator=gen)
    flat = torch.empty(M * K_ + 1, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:].view(M, K_)
    shifted.copy_(a)
    for x, y, route, tol in ((a, b, "f32", 1e-4), (shifted, b.bfloat16(), "mma", 1e-2)):
        before = dict(K.tiled_matmul.routes)
        got = K.tiled_matmul(x, y)
        assert {r: K.tiled_matmul.routes[r] - before[r] for r in before} == \
            {r: int(r == route) for r in before}
        want = ref.tiled_matmul_ref(x, y)
        assert got.shape == want.shape and got.dtype == x.dtype
        assert _err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_group_combine_at_the_lm_head(dtype, cuda_device):
    """The tied LM head's Combine B (2048 x 49408 -> 7 x 1024 x 24704),
    16-byte accesses, against the plain version on the card: f32 sums in
    another order (1e-5), in bf16 one rounding of each (one ulp)."""
    tl = talg.get("strassen")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2048, 49408, device=cuda_device, generator=gen).to(dtype)
    got = K.group_combine(x, tl.V)
    want = ref.group_combine_ref(ref.split_blocks(x, 2, 2), tl.V)
    assert got.shape == want.shape == (7, 1024, 24704) and got.dtype == dtype
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_batched_group_combine_at_attention(dtype, cuda_device):
    """The attention scores' Combine A at prefill (128 groups of 64 x 64 ->
    7 x 32 x 32: Y = 32, small blocks) and a misaligned copy of it (the
    narrow route), and at a padded key count of 66 (Y = 33, the narrow
    route), against the plain version on the card; each call's route
    counted."""
    tl = talg.get("strassen")
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(128, 64, 64, device=cuda_device, generator=gen).to(dtype)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    want = ref.group_combine_ref(ref.split_blocks(x, 2, 2), tl.U)
    odd = torch.randn(128, 64, 66, device=cuda_device, generator=gen).to(dtype)
    for inp, w, route in ((x, want, "vector"), (shifted, want, "narrow"),
                          (odd, ref.group_combine_ref(ref.split_blocks(odd, 2, 2), tl.U),
                           "narrow")):
        before = dict(K.batched_group_combine.routes)
        got = K.batched_group_combine(inp, tl.U)
        assert K.batched_group_combine.routes[route] == before[route] + 1
        assert got.shape == w.shape and got.dtype == dtype
        assert _err(got, w) <= (1e-5 if dtype == torch.float32 else 1e-2)


def _engine_run(cfg, quantize: bool, cuda_graphs: bool):
    """Warm a card engine, set the launch counts to 0, serve 6 ragged
    requests; returns (requests, launch counts, summary)."""
    from repro_torch.serve import ServeEngine
    engine = ServeEngine(cfg, max_slots=4, max_prompt_len=16, max_new_tokens=4, seed=0,
                         quantize=quantize, record_logits=True, cuda_graphs=cuda_graphs)
    engine.warm()
    K.reset_launch_counts()
    rng = np.random.default_rng(7)
    reqs = [engine.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=4)
            for n in (3, 8, 11, 16, 5, 9)]
    engine.run()
    return reqs, K.launch_state(), engine.summary()


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "int8"])
def test_cuda_engine_graphs_match_eager(quantize, cuda_device):
    """Forced strassen on the card: each bucket's step replayed as a CUDA
    graph gives the eager steps' tokens and logits (the same kernels on the
    same inputs: f32, bit-equal expected) and, through the counts each graph
    recorded at capture, the same kernel launches by kernel, route and
    shape."""
    import dataclasses
    from repro_torch.configs import lcma_smoke_config
    cfg = dataclasses.replace(lcma_smoke_config("granite_3_2b"), falcon_mode="strassen")
    greqs, gcounts, gsum = _engine_run(cfg, quantize, cuda_graphs=True)
    ereqs, ecounts, esum = _engine_run(cfg, quantize, cuda_graphs=False)
    assert gsum["cuda_graphs"] and gsum["graphs"] == gsum["warmed_shapes"] == 9
    assert not esum["cuda_graphs"] and esum["graphs"] == 0
    assert gsum["bucket_misses"] == esum["bucket_misses"] == 0
    for g, e in zip(greqs, ereqs):
        assert g.generated == e.generated
        for gl, el in zip(g.logits, e.logits):
            np.testing.assert_allclose(gl, el, rtol=1e-5, atol=1e-5)
    assert +gcounts == +ecounts
    names = ("group_combine_quant", "fused_gemm_combine_h_quant") if quantize else \
        ("group_combine", "batched_group_combine", "fused_gemm_combine_h",
         "batched_fused_gemm_combine_h")
    assert all(gcounts[n] > 0 for n in names), gcounts


@pytest.mark.cuda
def test_cuda_replays_run_their_capture_maps(cuda_device, tmp_path):
    """Each bucket graph keeps its capture map (one entry a device-operation
    node, in replay order, with the spans open at capture). Under the
    profiler a step runs its input copy, then exactly the map's operations,
    then its readback; a replay runs no span of the model."""
    import dataclasses
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    from repro_torch.configs import lcma_smoke_config
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(lcma_smoke_config("granite_3_2b"), falcon_mode="strassen")
    engine = ServeEngine(cfg, max_slots=4, max_prompt_len=16, max_new_tokens=4, seed=0)
    engine.warm()
    steps = engine.graphs.steps
    assert steps and all(st.map for st in steps.values())
    kinds = {k for st in steps.values() for k, _ in st.map}
    assert "kernel" in kinds and kinds <= {"kernel", "memcpy", "memset"}
    names = {f.name for st in steps.values() for _, stack in st.map for f in stack}
    assert {"rows.gather", "model.attention", "model.mlp", "falcon.leaf",
            "model.lm_head"} <= names
    engine.submit(list(range(1, 12)), max_new_tokens=3)
    engine.step()                                   # the prefill, unprofiled
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.step()                               # one decode step
    recs = trace.records()
    assert not {r.name for r in recs} & {"model.attention", "falcon.leaf", "rows.gather"}
    launch = next(r for r in recs if r.name == "serve.launch")
    assert launch.attrs["map"] is steps[launch.attrs["key"]].map
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = sorted((e["ts"], e["name"]) for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    assert len(ops) == len(launch.attrs["map"]) + 2
    assert ops[0][1].startswith("Memcpy HtoD") and ops[-1][1].startswith("Memcpy DtoH")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_generated_backend_matches_the_cpu(dtype, cuda_device, rng):
    """The generated "torch" backend on the card: a bf16 product keeps H in
    f32 (``torch.bmm(..., out_dtype=torch.float32)``; the CPU multiplies the
    upcast operands), and dense, grouped and precombined calls give the
    CPU's results within one rounding of the output (f32: the product's
    sums in another order)."""
    import repro_torch.api as tfalcon
    from repro_torch.core import codegen
    at = torch.tensor(rng.standard_normal((7, 24, 40)), dtype=dtype)
    bt = torch.tensor(rng.standard_normal((7, 40, 16)), dtype=dtype)
    h = codegen.product(at.to(cuda_device), bt.to(cuda_device), torch.float32)
    assert h.dtype == torch.float32
    torch.testing.assert_close(h.cpu(), at.float() @ bt.float(), atol=1e-4, rtol=1e-5)
    a = torch.tensor(rng.standard_normal((3, 26, 46)), dtype=dtype)
    w = torch.tensor(rng.standard_normal((46, 34)), dtype=dtype)
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else dict(atol=6e-2, rtol=2e-2)
    out = {}
    for dev in ("cpu", cuda_device):
        with tfalcon.use(tfalcon.FalconConfig(backend="torch", mode="laderman")):
            pw = tfalcon.plan_weight(w.to(dev))
            out[str(dev)] = [tfalcon.matmul(a[0].to(dev), w.to(dev)),
                             tfalcon.grouped_matmul(a.to(dev), w.to(dev)),
                             tfalcon.dense(a.to(dev), pw),
                             tfalcon.grouped_matmul(a.to(dev), pw)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.cuda
def test_cuda_capture_runs_without_garbage_collection(cuda_device):
    """An engine dropped in a reference cycle keeps its CUDA graphs until
    the garbage collector runs, and destroying a graph while another is
    being captured makes that capture fail: so the collector is off during
    a capture (and only there), and a step's warm-up run is not captured."""
    import gc
    from repro_torch.serve import StepGraphs
    seen = []
    base = torch.zeros(4, device=cuda_device)

    def fn(tokens):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return base + tokens

    collecting = gc.isenabled()
    step = StepGraphs(cuda_device).get(("t",), lambda: (fn, {"tokens": (4,)}, {}))
    assert seen == [(False, collecting), (True, False)] and gc.isenabled() == collecting
    step.load(tokens=np.arange(4))
    assert step().tolist() == [0.0, 1.0, 2.0, 3.0] and len(seen) == 2


CAPTURE_SYNC = """
import torch
from repro_torch.configs import smoke_config
from repro_torch.models import model as M
from repro_torch.serve import StepGraphs
from repro_torch.train.steps import make_decode_step
cfg = smoke_config("granite_3_2b")
params = M.init_params(cfg, 0, "cuda")
cache = M.init_cache(cfg, 2, 16, device="cuda")
decode = make_decode_step(cfg)
at = torch.tensor(3, device="cuda")        # a 0-d card tensor: int() reads it back
graphs = StepGraphs("cuda")
try:
    graphs.get(("decode", 2), lambda: (lambda tokens: decode(params, cache, tokens, at),
                                       {"tokens": (2, 1)}, {}))
except RuntimeError as e:
    print("raised:", type(e).__name__, str(e).splitlines()[0])
else:
    print("captured")
"""


@pytest.mark.cuda
def test_cuda_graph_capture_raises_on_a_sync(cuda_device):
    """A step that reads a card value back to the host inside its capture
    (``int(cache_index)`` of a 0-d CUDA tensor) makes the capture raise; it
    does not fall back to eager. In a process of its own: the failed capture
    leaves that process's CUDA state behind."""
    out = subprocess.run([sys.executable, "-c", CAPTURE_SYNC], capture_output=True,
                         text=True, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:"), out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_grouped_expert_ffn_matches_plain_version(dtype, cuda_device, rng):
    """One small MoE layer (8 experts, top-2, d 64, d_ff 128, 48 tokens) in
    forced strassen on the card: each of the three expert projections
    launches Group Combine over the activations and over the expert stack
    (#2) and the grouped fused GEMM + Combine H with per-expert B̃ (#4), and
    the layer gives the CPU's result through the kernels' plain versions
    (f32: the same sums in another order; bf16: the reference's bf16
    bounds)."""
    import repro_torch.api as tfalcon
    from repro_torch.models import moe
    d, ff, E, k = 64, 128, 8, 2
    p = moe.moe_init(torch.Generator().manual_seed(0), d, ff, E, dtype, "cpu")
    x = torch.tensor(rng.standard_normal((2, 24, d)), dtype=dtype)
    out = {}
    for dev in ("cpu", cuda_device):
        K.reset_launch_counts()
        with tfalcon.use(tfalcon.FalconConfig(mode="strassen")), torch.inference_mode():
            y, aux = moe.moe_apply({n: w.to(dev) for n, w in p.items()}, x.to(dev), k, 1.25)
        out[str(dev)] = (y.cpu(), aux.cpu(), K.launch_counts())
    (y, aux, counts), (y0, aux0, counts0) = out["cuda"], out["cpu"]
    assert counts["batched_group_combine"] == 6 and counts["batched_fused_gemm_combine_h"] == 3
    assert sum(counts0.values()) == 0
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else dict(atol=6e-2, rtol=2e-2)
    assert y.dtype == dtype and y.shape == y0.shape
    torch.testing.assert_close(y, y0, **tol)
    torch.testing.assert_close(aux, aux0, atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_moe_engine_graphs_match_eager(cuda_device):
    """dbrx's smoke config in forced strassen on the card: the MoE dispatch
    (comparisons, cumsum, index_put_ with accumulate, gathers) captures with
    each bucket's step, and the graphs give the eager steps' tokens, logits
    and launches, the grouped expert kernels among them."""
    import dataclasses
    from repro_torch.configs import smoke_config
    cfg = dataclasses.replace(smoke_config("dbrx_132b"), falcon_mode="strassen")
    greqs, gcounts, gsum = _engine_run(cfg, False, cuda_graphs=True)
    ereqs, ecounts, esum = _engine_run(cfg, False, cuda_graphs=False)
    assert gsum["cuda_graphs"] and gsum["graphs"] == gsum["warmed_shapes"] > 0
    assert gsum["bucket_misses"] == esum["bucket_misses"] == 0
    for g, e in zip(greqs, ereqs):
        assert g.generated == e.generated
        for gl, el in zip(g.logits, e.logits):
            np.testing.assert_allclose(gl, el, rtol=1e-5, atol=1e-5)
    assert +gcounts == +ecounts
    assert gcounts["batched_group_combine"] > 0 and gcounts["batched_fused_gemm_combine_h"] > 0


@pytest.mark.cuda
def test_cuda_ssd_scan_matches_plain_version(cuda_device, rng):
    """The SSD scan in forced strassen on the card: its four float32
    grouped contractions through Combine A and B (#2) and the grouped fused
    product on the SIMT route (#4), a ragged tail and an init state, against
    the plain einsum scan (the reference test's atol 2e-3, rtol 1e-3); the
    decode step's two contractions likewise."""
    import repro_torch.api as tfalcon
    from repro_torch.models import ssd
    from repro_torch.models.ssd_ref import einsum_ssd_scan
    B, L, H, P, G, N = 2, 45, 4, 16, 2, 16
    args = [torch.tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((B, L, H, P)), np.abs(rng.standard_normal((B, L, H))) * 0.1,
        np.abs(rng.standard_normal(H)) * 0.5, rng.standard_normal((B, L, G, N)),
        rng.standard_normal((B, L, G, N)))]
    s0 = torch.tensor(rng.standard_normal((B, H, N, P)), dtype=torch.float32)
    K.reset_launch_counts()
    with tfalcon.use(tfalcon.FalconConfig(mode="strassen")), torch.inference_mode():
        y, s = ssd.ssd_scan(*(a.to(cuda_device) for a in args), 16,
                            init_state=s0.to(cuda_device))
        yd, sd = ssd.ssd_decode_step(*(a[:, :1].to(cuda_device) if a.ndim > 1
                                       else a.to(cuda_device) for a in args),
                                     s0.to(cuda_device))
    counts = K.launch_counts()
    assert counts["batched_group_combine"] == 12 and counts["batched_fused_gemm_combine_h"] == 6
    y0, s0_ = einsum_ssd_scan(*args, 16, init_state=s0)
    torch.testing.assert_close(y.cpu(), y0, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(s.cpu(), s0_, atol=2e-3, rtol=1e-3)
    with tfalcon.use(tfalcon.FalconConfig(mode="gemm")):
        yd0, sd0 = ssd.ssd_decode_step(*(a[:, :1] if a.ndim > 1 else a for a in args), s0)
    torch.testing.assert_close(yd.cpu(), yd0, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(sd.cpu(), sd0, atol=2e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_370m", "hymba_1_5b"])
def test_cuda_ssm_engine_graphs_match_eager(arch, cuda_device):
    """The SSM and hybrid smoke configs in forced strassen on the card: the
    chunk loop, the first-chunk state zeroing and the state's scatter into
    the spare slot capture with each bucket's step, and the graphs give the
    eager steps' tokens, logits and launches."""
    import dataclasses
    from repro_torch.configs import smoke_config
    cfg = dataclasses.replace(smoke_config(arch), falcon_mode="strassen")
    greqs, gcounts, gsum = _engine_run(cfg, False, cuda_graphs=True)
    ereqs, ecounts, esum = _engine_run(cfg, False, cuda_graphs=False)
    assert gsum["cuda_graphs"] and gsum["graphs"] == gsum["warmed_shapes"] > 0
    assert gsum["bucket_misses"] == esum["bucket_misses"] == 0
    for g, e in zip(greqs, ereqs):
        assert g.generated == e.generated
        for gl, el in zip(g.logits, e.logits):
            np.testing.assert_allclose(gl, el, rtol=1e-5, atol=1e-5)
    assert +gcounts == +ecounts
    assert gcounts["batched_group_combine"] > 0 and gcounts["batched_fused_gemm_combine_h"] > 0
