"""Find a cell's pieces by the names in BENCHMARK.json.

  configuration   the file its ``configs`` entry names (JSON); its
                  ``runner`` key names bench/runners/<runner>.py
  traffic mix     bench/traffic/<traffic>.json
  per-layer metric  bench/metrics/<name>.py, which defines NAME, LAYER,
                  UNIT, MOVES, SOURCE and ``read(records)``

A later change adds any of these as new files and BENCHMARK.json entries;
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _load_module(path: str, prefix: str) -> ModuleType:
    stem = re.sub(r"\W", "_", os.path.splitext(os.path.basename(path))[0])
    spec = importlib.util.spec_from_file_location(f"{prefix}_{stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """BENCHMARK.json at ``root`` and the files it leads to."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.bench_dir = os.path.join(root, "bench")
        self._modules: Dict[str, ModuleType] = {}

    def path(self, *parts: str) -> str:
        return os.path.join(self.bench_dir, *parts)

    def workload_names(self) -> List[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.path("traffic", f"{name}.json")) as f:
            return json.load(f)

    def _module(self, kind: str, name: str) -> ModuleType:
        key = f"{kind}/{name}"
        if key not in self._modules:
            self._modules[key] = _load_module(
                self.path(kind, f"{name}.py"), f"bench_{kind}")
        return self._modules[key]

    def runner(self, name: str) -> ModuleType:
        return self._module("runners", name)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def cell(self, name: str) -> Cell:
        matches = [w for w in self.spec["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {self.workload_names()})")
        w = matches[0]
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m
                         else m["moves"] in reported)]
        return Cell(name, int(w["chips"]), self.config(w["config"]),
                    self.traffic(w["traffic"]), e2e, per_layer)
