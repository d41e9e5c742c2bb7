#!/usr/bin/env python
"""How often the cost model's one-pass baseline puts its slope inside the
spread of its own runs, under several timing schedules.

``scripts/calibrate_costs_torch.py`` takes the per-pass unit as the slope
of t_xla(C), the "xla" layout's segment sums over C stacked columns (the
median of each width's runs), and ``chip_smoke.py`` fails a fit whose
slope is not above the largest quartile spread of those runs. This script
repeats the baseline for ``--seconds`` on the script's inputs, cycling
through the schedules trial by trial so that each meets the same host,
and prints for each the share of trials whose slope is inside the spread:

  runs5      the reference's timer: 5 calls after 2 warm-ups;
  runs21     21 calls after 2 warm-ups;
  runs5x10   5 runs after 2 warm-ups, each the mean of 10 calls;
  gated      the script's ``gated_baseline``: runs5 again, up to
             BASE_ATTEMPTS times, while the slope is inside the spread.

    PYTHONPATH=src python scripts/calib_noise_torch.py --rows 6001215
    PYTHONPATH=src python scripts/calib_noise_torch.py --device cpu --rows 65536 --seconds 5
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(_ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(_ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analytics import dist_join_bench as DJB  # noqa: E402
from repro_torch.analytics.columnar import stacked_group_sums  # noqa: E402
from repro_torch.core.config import resolve_device  # noqa: E402


def load_calibrate():
    spec = importlib.util.spec_from_file_location(
        "calibrate_costs_torch",
        os.path.join(_ROOT, "scripts", "calibrate_costs_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the tables lie: cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--groups", type=int, default=512)
    ap.add_argument("--cols", type=int, nargs="+", default=[1, 2, 3, 4, 6])
    ap.add_argument("--seconds", type=float, default=120.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    calib = load_calibrate()
    cols = sorted(set(args.cols))
    rng = np.random.RandomState(0)        # the script's draws, in its order
    keys = torch.from_numpy(
        rng.randint(0, args.groups, args.rows).astype(np.int32)).to(dev)
    vals = {C: torch.from_numpy(
        rng.rand(args.rows, C).astype(np.float32)).to(dev) for C in cols}

    def timed(iters, k):
        def runs(C):
            def call():
                for _ in range(k):
                    stacked_group_sums(keys, vals[C], args.groups,
                                       layout="xla")
            return [t / k for t in DJB.bench_runs(
                call, device=dev, warmup=calib.WARMUP, iters=iters)]
        return runs

    def once(runs):
        xla = {C: runs(C) for C in cols}
        slope = calib.pass_slope(cols, {C: calib.median(r)
                                        for C, r in xla.items()})
        return [(slope, max(calib.quartile_spread(r)
                            for r in xla.values()))]

    schedules = {
        "runs5": lambda: once(timed(5, 1)),
        "runs21": lambda: once(timed(21, 1)),
        "runs5x10": lambda: once(timed(5, 10)),
        "gated": lambda: calib.gated_baseline(timed(5, 1), cols)[1],
    }
    trials = {name: [] for name in schedules}
    end = time.perf_counter() + args.seconds
    while time.perf_counter() < end or not trials["gated"]:
        for name, run in schedules.items():
            trials[name].append(run())
    if dev.type == "cuda":
        print(calib.card_line(dev))
    report = {}
    for name, got in trials.items():
        last = np.asarray([t[-1] for t in got]) * 1e6   # the kept attempt
        inside = int((last[:, 0] <= last[:, 1]).sum())
        report[name] = {
            "trials": len(got), "inside": inside,
            "share_inside": round(inside / len(got), 4),
            "slope_us": [round(float(np.median(last[:, 0])), 1),
                         round(float(last[:, 0].min()), 1),
                         round(float(last[:, 0].max()), 1)],
            "spread_us": [round(float(np.median(last[:, 1])), 1),
                          round(float(np.percentile(last[:, 1], 90)), 1),
                          round(float(last[:, 1].max()), 1)],
            "attempts": {str(n): sum(len(t) == n for t in got)
                         for n in sorted({len(t) for t in got})}}
        print(f"{name:9s} {json.dumps(report[name])}")
    print(json.dumps({"calib_noise": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
