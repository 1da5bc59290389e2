"""Guards of the PyTorch port: what it imports, where it runs, how it fails.

The port imports torch and numpy and nothing of JAX or of the reference
package; its entry points run on the card unless the caller asks for the
CPU, and on a machine without a card they fail instead of falling back.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import algorithms as talg
from repro_torch.kernels import build

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
    tl = talg.get(name)
    x = torch.tensor(rng.standard_normal((tl.m * 37, tl.k * 75)), dtype=torch.float32)
    q, s = K.group_combine_quant(x.to(cuda_device), tl.U, 25)
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
    """Ragged (element-wise loads, masked edges) and aligned (16-byte loads)
    against the plain version on the CPU: f32 sums in another order; in
    bf16 both round an f32 sum once, so they differ by one bf16 ulp at most."""
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
