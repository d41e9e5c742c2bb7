"""Run one cell of BENCHMARK.json once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (data drawn on the card from the seed, the kernels loaded or
built, the cell's own requests warmed up) is timed from process start to
the first timed request. The window then runs for ``--seconds``; with
``--trace 1`` under torch.profiler, and the cell's per-layer metrics are
reported in place of its end-to-end ones. After the window the peak
memory is read, the program's state is freed, and the answers are judged
against the plain reference (bench/reference/). The last lines on
standard error and the result line's last key give each number compared
beside its limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from bench import discovery
from bench.devtrace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules that the benchmark must not load
    (whole names: ``repro_torch`` is not ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def checks_of(readings: dict, limits: dict, failed: int) -> dict:
    """Each number compared with its limit: the widest relative gap of
    each query or kind of job that was judged, the integer mismatches,
    the failed requests, and how many answers were judged."""
    out = {f"rel_gap.{k}": {"value": readings["gaps"][k],
                            "limit": limits["rel_gap"][k]}
           for k in sorted(readings["gaps"])}
    out["mismatches"] = {"value": readings["mismatches"],
                         "limit": limits["mismatches"]}
    out["failed"] = {"value": failed, "limit": 0}
    out["answers"] = {"value": readings["answers"], "limit": "at least 1"}
    return out


def is_correct(checks: dict) -> bool:
    return (checks["answers"]["value"] >= 1
            and all(c["value"] <= c["limit"] for k, c in checks.items()
                    if k != "answers"))


def run_cell(spec: discovery.Benchmark, cell: discovery.Cell, seed: int,
             seconds: float, trace: bool, device, t0: float,
             control=None) -> dict:
    """One run of ``cell``: the result line's object, with "checks" last.
    ``control`` (a dtype) judges the reference in that precision instead
    of the program's answers (bench/readings.py)."""
    import torch
    cuda = device.type == "cuda"
    runner = spec.runner(cell.config["runner"]).Cell(
        cell.config, cell.traffic, seed, device)
    runner.setup()
    setup_s = time.monotonic() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(device) if trace else None
    out = runner.run(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if trace:
        records = out["records"]
        for m in cell.per_layer:
            value = spec.metric(m["name"]).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RuntimeError(f"{cell.name} reported no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": False, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if trace:
        r = out["records"]
        device_info["busy_s"] = r["busy_s"]
        device_info["window_s"] = r["window_s"]
        launched = sorted(r["kernel_records"].items())
        line["breakdown"] = {"device_ops": [list(x) for x in r["device_ops"]],
                             "idle_gaps": [list(x) for x in r["idle_gaps"]],
                             "kernel_launches": [list(x) for x in launched]}
        print("kernel launches in the trace: " + ", ".join(
            f"{k} {n}" for k, n in launched), file=sys.stderr)
    runner.release()
    readings = runner.check(control)
    checks = checks_of(readings, cell.config["limits"], out["failed"])
    line["correct"] = is_correct(checks)
    line["checks"] = checks
    return line


def main(argv, root: str, t0: float) -> int:
    args = parse(argv)
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print(f"bench: the program (src/repro_torch) is not under {root}",
              file=sys.stderr)
        return 2
    spec = discovery.Benchmark(root)
    try:
        cell = spec.cell(args.workload)
    except KeyError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process loaded {bad}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
