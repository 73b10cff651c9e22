"""What one run measures, found by name.

``BENCHMARK.json`` names the cell; its configuration is
``configs/<config>.json`` (with the network ``graphs/<graph>.py`` and
its plain reference ``reference/<reference>.py``), its traffic mix
``traffic/<traffic>.json``, each metric a reader ``metrics/<metric>.py``
and the system under test ``systems/<system>.py``.  Adding a cell, a mix, a
configuration or a metric adds files and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]        # the benchmark's folder


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: Optional[List[str]]
    moves: Optional[str] = None

    def reported_in(self, cell: "Cell", spec: Dict[str, Any]) -> bool:
        if self.workloads is not None:
            return cell.name in self.workloads
        if self.end_to_end:
            return True
        # no list: every cell that reports the metric it moves
        moved = next(m for m in metrics(spec) if m.name == self.moves)
        return moved.reported_in(cell, spec)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root.parent / "BENCHMARK.json")


def metrics(spec: Dict[str, Any]) -> List[Metric]:
    out = []
    for key, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in spec[key]:
            out.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                              e2e, m.get("workloads"), m.get("moves")))
    return out


def find_cell(name: str, spec: Dict[str, Any], root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration, traffic and
    metrics read from their files under ``root``."""
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[x['name'] for x in spec['workloads']]}")
    config = _json(root / "configs" / f"{w['config']}.json")
    traffic = _json(root / "traffic" / f"{w['traffic']}.json")
    cell = Cell(name, config, traffic, int(w["chips"]), [], [])
    for m in metrics(spec):
        if m.reported_in(cell, spec):
            (cell.end_to_end if m.end_to_end else cell.per_layer).append(m)
    return cell


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    key = f"portbench.{kind}.{name.replace('.', '_')}"
    if key in sys.modules and sys.modules[key].__file__ == str(path):
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} module {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def data(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """``<root>/data/<name>.json``."""
    return _json(root / "data" / f"{name}.json")


__all__ = ["Cell", "Metric", "ROOT", "data", "find_cell",
           "load_module", "load_spec", "metrics"]
