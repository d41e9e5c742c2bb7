"""Cells at sizes a CPU test run can hold: the harness end to end on the
CPU, with the kernels' plain versions (tests only; the command needs a
card). The cells held back from BENCHMARK.json (bench/held/) run here
too."""
from __future__ import annotations

import glob
import json
import time
from typing import Optional

import torch

from bench import discovery, harness

TPCH_ROWS = {"orders": 3000, "customer": 300, "supplier": 20, "part": 400,
             "nation": 25}
W_SIZES = {"agg": {"records": 40000, "groups": 4096},
           "join": {"build": 2000, "probe": 30000, "key_space": 8000}}


def with_held(spec: discovery.Benchmark) -> discovery.Benchmark:
    """``spec`` with the entries of every file under bench/held/ added."""
    for path in sorted(glob.glob(spec.path("held", "*.json"))):
        with open(path) as f:
            held = json.load(f)
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            spec.spec[group].extend(held[group])
    return spec


def shrink(cell: discovery.Cell) -> discovery.Cell:
    """``cell`` with its configuration at the tiny sizes above."""
    if cell.config["runner"] == "tpch":
        cell.config["rows"] = dict(TPCH_ROWS)
    else:
        cell.config["sizes"].update(
            {k: dict(v) for k, v in W_SIZES.items()})
    return cell


def run(name: str, *, root: str, seed: int = 7, seconds: float = 0.5,
        trace: bool = False, control: Optional[torch.dtype] = None,
        spec: Optional[discovery.Benchmark] = None) -> dict:
    """One tiny run of cell ``name`` on the CPU: the result line."""
    spec = spec or with_held(discovery.Benchmark(root))
    cell = shrink(spec.cell(name))
    return harness.run_cell(spec, cell, seed, seconds, trace,
                            torch.device("cpu"), time.monotonic(),
                            control=control)
