"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``portbench/`` one file for each configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``), cell
(``cells/<cell>.json``: the limits of its check) and metric
(``metrics/<metric>.py``). A configuration's ``family`` names its port
adapter (``models/<family>.py``) and its plain reference
(``reference/<family>.py``). Adding any of these is adding a file; nothing
here lists them."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["NAME", "UNIT", "Bench", "Cell", "load_module"]

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PACKAGE = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name`` (file names here
    may hold dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    home: Path

    def model_module(self, kind: str):
        """``models/<family>.py`` (kind "models") or ``reference/<family>.py``."""
        family = self.config["family"]
        return load_module(self.home / kind / f"{family}.py", f"portbench_{kind}_{family}")

    def metric_reader(self, name: str):
        return load_module(self.home / "metrics" / f"{name}.py",
                           "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


class Bench:
    """``BENCHMARK.json`` of ``root`` and the benchmark's files under ``home``."""

    def __init__(self, root: Path, home: Path = PACKAGE):
        self.root, self.home = Path(root), Path(home)
        self.data = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.data["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
        w = cells[name]
        config = _json(self.home / "configs" / f"{w['config']}.json")
        traffic = _json(self.home / "traffic" / f"{w['traffic']}.json")
        check = _json(self.home / "cells" / f"{name}.json")

        def mine(metric):
            return name in metric.get("workloads", [name])
        e2e = [m for m in self.data["end_to_end"] if mine(m)]
        reported = {m["name"] for m in e2e}
        layer = [m for m in self.data["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return Cell(name, w, config, traffic, check, e2e, layer, self.home)
