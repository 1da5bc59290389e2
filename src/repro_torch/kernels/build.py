"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, named by a hash of the sources and flags
(``build/kernels/<name>-<hash>.so`` at the repository root), and loaded with
``ctypes``. A library is built at its first use, so importing this module
compiles nothing; :func:`build_all` starts one ``nvcc`` per source at once
and waits for all of them. A failed build raises with the compiler's output;
a successful one keeps it beside the library (``<name>-<hash>.log``), where
:func:`ptxas_report` reads each kernel's registers, shared memory and spills.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "DTYPE_CODES",
           "library", "build_all", "check", "ptxas_report"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <repo>/src/repro_torch/kernels/build.py -> <repo>/build/kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("group_combine", "fused_gemm", "quant_combine", "tiled_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "group_combine": {
        # device, in, out, table, table_len, dtype, G, R, d1, d2, X, Y, vec, ty,
        # tx, rows, smem_bytes, stream
        "falcon_group_combine": [_I, _P, _P, _P] + [_I] * 13 + [_P],
    },
    "fused_gemm": {
        # device, at, bt, out, ws, table, in_dtype, out_dtype, G, R, mn, X, Y,
        # Z, bt_group_stride, vec, bx, bz, splits, smem_bytes, stream
        "falcon_fused_gemm_combine_h": [_I] + [_P] * 5 + [_I] * 8
        + [ctypes.c_longlong] + [_I] * 5 + [_P],
    },
    "quant_combine": {
        # device, in, q, scales, table, dtype, R, d1, d2, X, Y, by, warps, stream
        "falcon_group_combine_quant": [_I] + [_P] * 4 + [_I] * 8 + [_P],
        # device, aq, as, bq, bs, out, ws, table, out_dtype, R, mn, X, Y, Z,
        # by, vec, bx, bz, splits, smem_bytes, stream
        "falcon_fused_gemm_quant": [_I] + [_P] * 7 + [_I] * 12 + [_P],
    },
    "tiled_matmul": {
        # device, a, b, c, in_dtype, out_dtype, M, K, N, bm, bn, stream
        "falcon_tiled_matmul": [_I] + [_P] * 3 + [_I] * 7 + [_P],
        # device, a, b, c, ws, out_dtype, M, K, N, bm, bn, splits, smem_bytes, stream
        "falcon_tiled_matmul_wgmma": [_I] + [_P] * 4 + [_I] * 8 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    nvcc = _nvcc()
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.falcon_error_string.argtypes = [ctypes.c_int]
    lib.falcon_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> dict[str, float]:
    """Build every kernel library that is not built yet, all nvcc processes
    at once, and load them. Returns the build seconds of each library (0.0
    for one that was already built)."""
    seconds = {}
    with _lock:
        started = []
        t0 = time.perf_counter()
        for name in SOURCES:
            if name in _libs:
                seconds[name] = 0.0
            elif _lib_path(name).exists():
                _libs[name] = _load(name, _lib_path(name))
                seconds[name] = 0.0
            else:
                started.append((name, *_start(name)))
        for name, proc, tmp, out in started:
            _finish(name, proc, tmp, out)
            seconds[name] = time.perf_counter() - t0
            _libs[name] = _load(name, out)
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path = _lib_path(name)
                if not path.exists():
                    _finish(name, *_start(name))
                lib = _libs[name] = _load(name, path)
    return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(name: str) -> list[dict]:
    """Each kernel of ``csrc/<name>.cu`` as ``-Xptxas -v`` reported it when
    the library was built: mangled name, registers per thread, static shared
    memory bytes, spill store and load bytes. Empty if no build log is kept."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return []
    out, cur = [], None
    for line in log.read_text().splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif cur is not None and (m := _SPILL.search(line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := _USED.search(line)):
            cur["registers"], cur["smem"] = int(m.group(1)), int(m.group(2) or 0)
    return out


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = lib.falcon_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
