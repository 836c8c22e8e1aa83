"""The benchmark's data, found by name from ``BENCHMARK.json``.

A cell (one ``workloads`` entry) names a configuration and a traffic mix.
Each lives in a file of its own under this folder: the configuration in
the file its ``configs`` entry names (``configs/<config>.json``), the mix
in ``traffic/<traffic>.json``, the limits of its correctness comparison in
``limits/<cell>.json``, each per-layer metric's reader in
``metrics/<metric>.py`` and each configuration's plain reference in
``reference/<config>.py``. Nothing here knows a cell, a metric or a
configuration by name: a later cell, metric or configuration is added by
adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

__all__ = ["Cell", "Metric", "Bench", "load", "load_module", "HERE", "ROOT"]


@dataclass(frozen=True)
class Metric:
    """One metric of ``end_to_end`` or ``per_layer``."""

    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[tuple] = None  # None: every cell that reports what it moves
    bound: Optional[float] = None
    layer: Optional[str] = None
    moves: Optional[str] = None


@dataclass(frozen=True)
class Cell:
    """One ``workloads`` entry with its configuration and traffic mix read."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # the end-to-end metrics this cell reports
    per_layer: tuple  # the per-layer metrics this cell reports
    references: Path = HERE / "reference"  # the folder of its configuration's reference


def _metric(entry: dict) -> Metric:
    wl = entry.get("workloads")
    return Metric(entry["name"], entry["unit"], entry["better"], entry["source"],
                  tuple(wl) if wl is not None else None, entry.get("bound"),
                  entry.get("layer"), entry.get("moves"))


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, data: dict, root: Path = ROOT) -> None:
        self.data = data
        self.root = root
        self.configs = {c["name"]: c for c in data["configs"]}
        self.workloads = {w["name"]: w for w in data["workloads"]}
        self.end_to_end = [_metric(m) for m in data["end_to_end"]]
        self.per_layer = [_metric(m) for m in data["per_layer"]]

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(self.workloads)}")
        w = self.workloads[name]
        cfg_entry = self.configs[w["config"]]
        config = _read_json(self.root / cfg_entry["file"])
        traffic = _read_json(HERE / "traffic" / f"{w['traffic']}.json")
        limits = _read_json(HERE / "limits" / f"{name}.json")
        e2e = tuple(m for m in self.end_to_end if m.workloads is None or name in m.workloads)
        reported = {m.name for m in e2e}
        layer = tuple(m for m in self.per_layer
                      if (name in m.workloads if m.workloads is not None
                          else m.moves in reported))
        return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, traffic, limits,
                    e2e, layer)


def load(path: Path = BENCHMARK_JSON) -> Bench:
    return Bench(_read_json(path), Path(path).resolve().parent)


_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_MODULES: Dict[Path, ModuleType] = {}


def load_module(kind: str, name: str, folder: Optional[Path] = None) -> ModuleType:
    """The module ``<kind>/<name>.py`` of this folder (``metrics`` or
    ``reference``), or ``<name>.py`` of ``folder``, loaded from its file: a
    metric's name may hold dots."""
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    path = (folder or HERE / kind) / f"{name}.py"
    mod = _MODULES.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(f"hanabi_bench.{kind}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod
