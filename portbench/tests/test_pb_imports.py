"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module name; nothing reads the old benchmarks folder."""
from __future__ import annotations

import ast
import subprocess
import sys
import types
from pathlib import Path

from portbench import run

HOME = Path(__file__).resolve().parents[1]
REPO = HOME.parent


def test_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for path in HOME.rglob("*.py"):
        if "tests" in path.relative_to(HOME).parts:
            continue
        bad = _imports(path) & (run.FORBIDDEN | {"benchmarks"})
        assert not bad, f"{path} imports {bad}"
        assert "benchmarks/" not in path.read_text(), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (HOME / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_loads_no_forbidden_module():
    # a fresh interpreter: the port and the harness on the CPU path, no card
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from portbench import run\n"
            "from portbench.harness import check, serve, trace, readers, work, traffic\n"
            "from portbench.reference import dense_decoder\n"
            "from portbench.models.dense_decoder import port_config\n"
            "import repro_torch.serve, repro_torch.kernels\n"
            "print(run.forbidden_modules())\n") % (str(REPO), str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_exits_nonzero_with_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(HOME / "run.py"), "--workload",
                          "granite_3_2b.prefill_docs", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmarks_files_exits_nonzero(tmp_path):
    import shutil
    shutil.copytree(HOME, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "granite_3_2b.prefill_docs", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
