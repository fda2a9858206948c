"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs`` gives, and a traffic mix, ``mixes/<traffic>.json``.  A
configuration names its graph's generator, ``graphs/<generator>.py``,
which :func:`perfbench.generators.generate` loads.  Its
check's limits are ``limits/<cell>.json``; each metric's reader is
``metrics/<metric>.py``, or, for a quantity split by the cells it is
reported in (``evps.pr``, ``evps.sssp``), the quantity's reader
``metrics/<quantity>.py``, the name up to its first dot.  A mix's
program has its plain solver in ``reference/<program>.py``.  Adding a
cell, a mix, a graph or a metric adds files and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

__all__ = ["HERE", "Benchmark", "Cell", "load", "load_module"]

HERE = Path(__file__).resolve().parent


def load_module(path: Path) -> ModuleType:
    """A Python file as a module of its own (metric names may hold
    dots, so they are loaded by path, not imported by name)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench._loaded." + path.stem.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict


@dataclasses.dataclass
class Benchmark:
    root: Path
    spec: dict
    here: Path = HERE

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        w = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        return Cell(name=name, chips=int(w["chips"]),
                    config=_json(self.root / configs[w["config"]]["file"]),
                    mix=_json(self.here / "mixes" / f"{w['traffic']}.json"),
                    limits=_json(self.here / "limits" / f"{name}.json"))

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics whose ``workloads`` list ``cell``."""
        for m in self.spec["per_layer"]:
            if "workloads" not in m:
                raise KeyError(f"per-layer metric {m['name']!r} lists no "
                               f"workloads")
        return [m for m in self.spec["per_layer"]
                if cell in m["workloads"]]

    def reader(self, metric: str) -> ModuleType:
        own = self.here / "metrics" / f"{metric}.py"
        if own.is_file():
            return load_module(own)
        quantity = metric.split(".", 1)[0]
        return load_module(self.here / "metrics" / f"{quantity}.py")

    def reference(self, program: str) -> ModuleType:
        return load_module(self.here / "reference" / f"{program}.py")


def load(root: Optional[Path] = None, spec: Optional[dict] = None
         ) -> Benchmark:
    """The benchmark of the checkout at ``root`` (default: the parent of
    this package), or of ``spec`` in place of its ``BENCHMARK.json``."""
    root = Path(root) if root is not None else HERE.parent
    if spec is None:
        spec = _json(root / "BENCHMARK.json")
    return Benchmark(root=root, spec=spec)
