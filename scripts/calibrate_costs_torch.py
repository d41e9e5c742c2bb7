#!/usr/bin/env python
"""Calibrate the port's planner cost constants from measured
microbenchmarks: ``scripts/calibrate_costs.py`` on ``repro_torch``.

The cost model (``planner.aggregate_costs``) prices every physical
Aggregate layout in pass-equivalents over the input rows, from hand-set
constants that are the reference's. This script measures them on the
device the tables lie on (the CUDA device by default; ``--device cpu``
for the CPU) and writes a JSON profile that ``planner.load_cost_profile``
of either package reads:

  1. one-pass baseline: t_xla(C), the "xla" layout's segment sums over C
     stacked columns; its slope over C is the per-pass unit time. The
     port's ``columnar.segment_sum`` sums every column in one call while
     the longest segment holds at most ``SERIAL_SEGMENT_ROWS`` rows, and
     one call per column beyond, so the slope is a pass only when rows /
     groups is well above that (about 11.7k rows a segment at TPC-H SF1's
     lineitem over 512 groups);
  2. fused sweep: t_dense(C) / pass_time fitted to fixed + per_col * C;
  3. sort: t_sort / (pass_time * log2 n), a stable sort of the keys.

``--sweep-groups`` fits ``dense_group_limit`` (the largest swept group
count before the dense layout's first sustained loss to the partitioned
one) and ``partition_capacity_factor`` (the smallest capacity factor with
no overflow on zipf(e=0.5) keys, times 1.25). ``--dist`` fits
``dist_route_factor`` from the broadcast vs partitioned join crossover,
``--exchange`` fits ``radix_route_factor`` from the argsort vs radix
Exchange crossover (both on a virtual mesh, through
``repro_torch.analytics.dist_join_bench``), and ``--morsel`` fits
``morsel_split_rows`` from the serving scheduler's whole-plan vs
split-probe crossover. ``--refresh PROFILE.json`` instead runs a recorded
selective-probe join on a virtual mesh and rewrites the profile's
drifting entries through ``telemetry.refresh_profile``.

Every fit is a pure function of the measured numbers (``fit_*``), with
the reference's arithmetic; every measurement goes through
``dist_join_bench.bench_runs`` (host clock, a device-wide synchronize
after each call), the timer of the benchmarks the fits price, with the
reference's two warm-up calls here. The one-pass baseline is measured
again, up to ``BASE_ATTEMPTS`` times, while its slope lies inside the
spread of a width's own runs; every attempt is kept in the profile.

    PYTHONPATH=src python scripts/calibrate_costs_torch.py --out cost_profile.json
    PYTHONPATH=src python scripts/calibrate_costs_torch.py --sweep-groups --dist \\
        --exchange --morsel --out cost_profile.json
    PYTHONPATH=src python scripts/calibrate_costs_torch.py --refresh cost_profile.json
    PYTHONPATH=src python scripts/calibrate_costs_torch.py --device cpu --rows 65536
    >>> planner.load_cost_profile("cost_profile.json")
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(_ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(_ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analytics import dist_join_bench as DJB  # noqa: E402
from repro_torch.analytics import plan as L  # noqa: E402
from repro_torch.analytics import planner, telemetry  # noqa: E402
from repro_torch.analytics.columnar import (DENSE_GROUP_LIMIT,  # noqa: E402
                                            stacked_group_sums)
from repro_torch.analytics.datasets import zipf  # noqa: E402
from repro_torch.analytics.service.scheduler import (  # noqa: E402
    MorselScheduler)
from repro_torch.core.config import (PlacementPolicy,  # noqa: E402
                                     resolve_device)


# ---------------------------------------------------------------------------
# the fits: pure functions of the measured numbers
# ---------------------------------------------------------------------------
def fit_base(cols, t_xla, t_dense, t_sort: float, n_rows: int) -> dict:
    """fused_fixed, fused_per_col, sort_pass_factor and pass_time_us from
    seconds per call: t_xla and t_dense map each width C to a time."""
    xs = np.asarray(cols, np.float64)
    # per-pass unit time = slope of the one-segment-op-per-column layout
    pass_time = max(pass_slope(cols, t_xla), 1e-9)
    # fused pass-equivalents: fixed + per_col * C
    fused_eq = np.asarray([t_dense[C] / pass_time for C in cols])
    per_col, fixed = np.polyfit(xs, fused_eq, 1)
    # the model needs positive constants; a negative fit (a noisy run)
    # falls back toward the hand-set shape
    fixed = max(float(fixed), 0.05)
    per_col = max(float(per_col), 0.01)
    sort_factor = max(t_sort / (pass_time * math.log2(max(n_rows, 2))), 0.01)
    return {"fused_fixed": round(fixed, 4),
            "fused_per_col": round(per_col, 4),
            "sort_pass_factor": round(float(sort_factor), 4),
            "pass_time_us": round(pass_time * 1e6, 3)}


def pass_slope(cols, t_xla) -> float:
    """Least-squares slope of t_xla(C) over the widths ``cols``."""
    return float(np.polyfit(np.asarray(cols, np.float64),
                            [t_xla[C] for C in cols], 1)[0])


def quartile_spread(runs: list) -> float:
    """Distance between the quartiles of sorted runs."""
    return runs[3 * len(runs) // 4] - runs[len(runs) // 4]


def crossover(wins) -> float:
    """The crossover size of an ascending [(size, challenger won)] sweep:
    the geometric midpoint of the first win with its losing neighbour (the
    first size when the first point wins), or twice the largest size when
    the challenger never wins, so the model keeps the incumbent there."""
    for i, (n, won) in enumerate(wins):
        if won:
            return math.sqrt(wins[i - 1][0] * n) if i else float(n)
    return 2.0 * wins[-1][0]


def fit_dist(raw, probe: int, n_shards: int) -> float:
    """dist_route_factor from {build: {"broadcast": us, "partitioned":
    us}}: broadcast moves n_build * (n-1) rows, partitioned
    (n_probe + n_build) * (n-1)/n * factor; equal at the crossover B*."""
    sweep = sorted((int(b), d) for b, d in raw.items())
    b_star = crossover([(b, d["partitioned"] < d["broadcast"])
                        for b, d in sweep])
    factor = b_star * n_shards / (probe + b_star)
    return max(round(float(factor), 4), 0.01)


def fit_exchange(raw, n_shards: int, sort_pass_factor: float) -> float:
    """radix_route_factor from {probe: {"argsort": us, "radix": us}}: the
    argsort layout costs sort_pass_factor * log2(per-shard rows), the
    radix layout the flat factor; equal at the crossover P*."""
    sweep = sorted((int(p), d) for p, d in raw.items())
    p_star = crossover([(p, d["radix"] < d["argsort"]) for p, d in sweep])
    factor = sort_pass_factor * math.log2(max(p_star / n_shards, 2.0))
    return max(round(float(factor), 4), 0.01)


def fit_morsel(wins) -> int:
    """morsel_split_rows from ascending [(probe rows, split won)]."""
    return max(int(round(crossover(wins))), 1)


def fit_dense_group_limit(wins, builtin: int = DENSE_GROUP_LIMIT) -> int:
    """The largest group count won by the dense layout before its first
    SUSTAINED loss (a loss followed by another, or at the end of the
    range) to the partitioned one, from ascending [(G, dense won)].
    ``builtin`` when dense never sustainedly loses; just below the
    smallest point when it wins nowhere before the loss."""
    cross_idx = next(
        (i for i, (_G, won) in enumerate(wins)
         if not won and (i == len(wins) - 1 or not wins[i + 1][1])), None)
    if cross_idx is None:
        return int(builtin)
    prior_wins = [G for G, won in wins[:cross_idx] if won]
    return int(max(prior_wins) if prior_wins else wins[0][0] - 1)


def fit_capacity_factor(overflows):
    """1.25 x the smallest capacity factor with zero overflow, from
    ascending [(cf, overflowed rows)]; None when every factor overflowed
    (the planner then keeps the context's factor)."""
    for cf, ovf in overflows:
        if ovf == 0:
            return round(float(cf) * 1.25, 4)
    return None


# ---------------------------------------------------------------------------
# the measurements
# ---------------------------------------------------------------------------
WARMUP = 2                     # untimed calls, as the reference's time_fn
# Attempts at the one-pass baseline. A slope inside the spread of a
# width's own runs prices noise, not a pass. On a card a call at TPC-H
# SF1's size (~1 ms) is mostly host issue, and the shared host's speed
# drifts, so now and then a slow stretch falls inside one width's runs;
# the baseline is then measured again (scripts/calib_noise_torch.py counts
# how often, and shows that more runs, or runs of many calls each, do not
# narrow the spread).
BASE_ATTEMPTS = 5


def median(runs: list) -> float:
    return runs[len(runs) // 2]


def gated_baseline(runs, cols):
    """({C: sorted seconds}, [(slope, largest quartile spread) of every
    attempt]) of the one-pass baseline, ``runs(C)`` giving one width's
    sorted runs: measured again, up to BASE_ATTEMPTS times, until the
    slope clears the spread (or the runs do not spread at all); the last
    attempt's runs are kept."""
    attempts = []
    for _ in range(BASE_ATTEMPTS):
        xla = {C: runs(C) for C in cols}
        slope = pass_slope(cols, {C: median(r) for C, r in xla.items()})
        spread = max(quartile_spread(r) for r in xla.values())
        attempts.append((slope, spread))
        if slope > spread or spread == 0:
            break
    return xla, attempts


def measure_base(n_rows: int, n_groups: int, cols, mode, dev):
    """({C: sorted xla seconds}, {C: dense seconds}, sort seconds, the
    baseline's attempts (``gated_baseline``))."""
    rng = np.random.RandomState(0)
    keys = torch.from_numpy(
        rng.randint(0, n_groups, n_rows).astype(np.int32)).to(dev)
    # every table is drawn before the first timing, in the reference's
    # draw order: a card left idle while numpy draws the next width times
    # its first calls slower, which spreads that width's runs
    tables = {(layout, C): torch.from_numpy(
        rng.rand(n_rows, C).astype(np.float32)).to(dev)
        for layout in ("xla", "dense") for C in cols}

    def runs(layout, C):
        vals = tables[layout, C]
        return DJB.bench_runs(lambda: stacked_group_sums(
            keys, vals, n_groups, layout=layout, mode=mode), device=dev,
            warmup=WARMUP)

    xla, attempts = gated_baseline(lambda C: runs("xla", C), cols)
    dense = {C: median(runs("dense", C)) for C in cols}
    t_sort = median(DJB.bench_runs(lambda: torch.sort(keys, stable=True),
                                   device=dev, warmup=WARMUP))
    return xla, dense, t_sort, attempts


def sweep_groups(rows: int, groups_sweep, cols: int, mode, capacity_factors,
                 dev) -> dict:
    """The dense/partitioned crossover over n_groups and the smallest
    zero-overflow partition capacity factor under zipf skew:
    {"dense_group_limit", "partition_capacity_factor", "raw"}."""
    rng = np.random.RandomState(1)
    raw = {"dense": {}, "partitioned": {}}
    wins = []                      # (G, dense_won) in ascending-G order
    for G in sorted(groups_sweep):
        keys = torch.from_numpy(rng.randint(0, G, rows).astype(np.int32))
        vals = torch.from_numpy(rng.rand(rows, cols).astype(np.float32))
        keys, vals = keys.to(dev), vals.to(dev)
        t = {}
        for layout in ("dense", "partitioned"):
            t[layout] = median(DJB.bench_runs(lambda: stacked_group_sums(
                keys, vals, G, layout=layout, mode=mode), device=dev,
                warmup=WARMUP))
            raw[layout][str(G)] = round(t[layout] * 1e6, 1)
        wins.append((G, t["dense"] <= t["partitioned"]))
    limit = fit_dense_group_limit(wins)

    ds = zipf(rows, max(groups_sweep), seed=3)
    keys = torch.from_numpy(ds.keys).to(dev)
    vals = torch.from_numpy(np.stack([ds.vals] * cols, axis=1)).to(dev)
    overflows = []
    for cf in sorted(capacity_factors):
        _sums, ovf = stacked_group_sums(
            keys, vals, max(groups_sweep), layout="partitioned", mode=mode,
            capacity_factor=cf)
        overflows.append((cf, int(ovf)))
        if int(ovf) == 0:
            break
    raw["overflow_at_cf"] = {str(cf): ovf for cf, ovf in overflows}
    fitted_cf = fit_capacity_factor(overflows)
    if fitted_cf is None:
        print(f"sweep_groups: no overflow-free capacity factor in "
              f"{sorted(capacity_factors)} (overflows: "
              f"{raw['overflow_at_cf']}); leaving "
              f"partition_capacity_factor unset", file=sys.stderr)
    return {"dense_group_limit": limit,
            "partition_capacity_factor": fitted_cf, "raw": raw}


def calibrate_dist(probe: int, builds, n_shards: int, dev):
    """(dist_route_factor, raw sweep) from ``dist_join_bench.sweep``."""
    raw = DJB.sweep(probe, builds, n_shards, dev)
    return fit_dist(raw, probe, n_shards), raw


def calibrate_exchange(probes, build: int, n_shards: int,
                       sort_pass_factor: float, dev):
    """(radix_route_factor, raw sweep) from ``dist_join_bench.exchange``,
    fitted against the sort factor just measured so both sides of
    ``choose_exchange_impl`` share one unit."""
    raw = DJB.exchange(build, probes, n_shards, dev)
    return fit_exchange(raw, n_shards, sort_pass_factor), raw


def calibrate_morsel(probes, n_pools: int, workers: int, dev,
                     morsels_per_pool: int = 4):
    """(morsel_split_rows, raw sweep): one PK-FK join pipeline through
    ``MorselScheduler.run`` as one whole-plan morsel and split into probe
    morsels, forced each way through the profile's morsel_split_rows
    (n+1 never splits, 1 always). Each scheduler is closed before the
    profile is swapped again; the profile is restored at the end."""
    rng = np.random.RandomState(7)
    dim_rows = 256
    base = planner.current_cost_profile()
    raw = {}
    wins = []                          # (probe_rows, split_won) ascending
    try:
        for n in sorted(probes):
            fk = rng.randint(0, dim_rows, n).astype(np.int32)
            fv = rng.rand(n).astype(np.float32)
            dv = rng.rand(dim_rows).astype(np.float32)
            tables = {
                "fact": {"fk": torch.from_numpy(fk).to(dev),
                         "fv": torch.from_numpy(fv).to(dev)},
                "dim": {"pk": torch.arange(dim_rows, dtype=torch.int32,
                                           device=dev),
                        "dv": torch.from_numpy(dv).to(dev)},
            }
            p = L.LogicalPlan(
                L.scan("fact").join(L.scan("dim"), "fk", "pk", {"dv": "dv"})
                .aggregate("fk", dim_rows, s=("sum", "fv"),
                           c=("count", "fv")), None)
            ctx = planner.ExecutionContext()
            morsel = max(n // (n_pools * morsels_per_pool), 1)
            t = {}
            for tag, threshold in (("single", n + 1), ("split", 1)):
                planner.set_cost_profile(dataclasses.replace(
                    base, morsel_split_rows=threshold))
                with MorselScheduler(n_pools=n_pools,
                                     workers_per_pool=workers,
                                     morsel_rows=morsel) as sched:
                    t[tag] = median(DJB.bench_runs(
                        lambda: sched.run(p, tables, ctx), device=dev,
                        warmup=WARMUP))
            raw[str(n)] = {k: round(v * 1e6, 1) for k, v in t.items()}
            wins.append((n, t["split"] < t["single"]))
    finally:
        planner.set_cost_profile(base)
    return fit_morsel(wins), raw


def refresh_from_telemetry(path: str, n_shards: int, dev) -> dict:
    """Rewrite ``path``'s drifting cost entries from observed telemetry
    of one recorded selective-probe partitioned join on a virtual mesh of
    ``n_shards``. Returns the rewritten entries ({} when none drifted).
    The builtin profile is back in place afterwards."""
    profile = planner.load_cost_profile(path)
    try:
        rng = np.random.RandomState(0)
        n_rows = ((1 << 12) // n_shards) * n_shards
        dim_rows = 512
        fk = rng.randint(0, dim_rows, n_rows).astype(np.int32)
        fv = rng.rand(n_rows).astype(np.float32)
        dv = rng.rand(dim_rows).astype(np.float32)
        tables = {
            "fact": {"fk": torch.from_numpy(fk).to(dev),
                     "fv": torch.from_numpy(fv).to(dev)},
            "dim": {"pk": torch.arange(dim_rows, dtype=torch.int32,
                                       device=dev),
                    "dv": torch.from_numpy(dv).to(dev)},
        }
        # selective probe ahead of a forced-partitioned join: the routed
        # traffic the profile's dist_route_factor prices, observed exactly
        p = L.LogicalPlan(
            L.scan("fact").filter(L.col("fv") < 0.1)
            .join(L.scan("dim"), "fk", "pk", {"dv": "dv"})
            .aggregate("fk", dim_rows, c=("count", "fv"), x=("max", "dv")),
            ("c", "x"))
        ctx = planner.ExecutionContext(executor="cost", n_shards=n_shards,
                                       policy=PlacementPolicy.INTERLEAVE,
                                       dist_join="partitioned")
        telemetry.registry().clear()
        with telemetry.recording():
            planner.compile_plan(p, tables, ctx)(tables)
        refreshed = telemetry.refresh_profile(profile)
    finally:
        planner.set_cost_profile(None)
    if refreshed is profile:
        print(f"refresh: no cost entry drifted outside the "
              f"{telemetry.DRIFT_BAND}x band; {path} left unchanged")
        return {}
    with open(path) as f:
        raw = json.load(f)
    updates = {}
    for entry in ("dist_route_factor", "compact_margin",
                  "filter_selectivity"):
        new = getattr(refreshed, entry)
        if new is not None and new != getattr(profile, entry):
            updates[entry] = new
    raw.update(updates)
    raw["refreshed_from"] = "telemetry"
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)
        f.write("\n")
    print(f"refresh: rewrote {sorted(updates)} in {path}: "
          + ", ".join(f"{k}={v}" for k, v in sorted(updates.items())))
    return updates


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(dev)}, power limit not read ({e})"
    if out.returncode != 0:
        return (f"{torch.cuda.get_device_name(dev)}, power limit not read "
                f"({out.stderr.strip()})")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the tables lie: cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=1 << 18,
                    help="input rows for the microbenchmarks")
    ap.add_argument("--groups", type=int, default=512,
                    help="group domain (must stay under DENSE_GROUP_LIMIT)")
    ap.add_argument("--cols", type=int, nargs="+", default=[1, 2, 3, 4, 6],
                    help="stacked-matrix widths to sweep")
    ap.add_argument("--mode", default=None,
                    help="kernel mode (auto | cuda | ref; None = "
                         "REPRO_TORCH_KERNEL_MODE or auto)")
    ap.add_argument("--dist", action="store_true",
                    help="also measure the broadcast vs partitioned "
                         "distributed-join crossover on a virtual mesh "
                         "and fit dist_route_factor")
    ap.add_argument("--exchange", action="store_true",
                    help="also measure the argsort vs radix Exchange "
                         "routing-layout crossover on a virtual mesh and "
                         "fit radix_route_factor")
    ap.add_argument("--exchange-probes", type=int, nargs="+",
                    default=[1 << b for b in range(10, 19, 2)],
                    help="probe sizes to sweep for the --exchange "
                         "crossover")
    ap.add_argument("--exchange-build", type=int, default=1 << 14,
                    help="build-side size for the --exchange sweep")
    ap.add_argument("--morsel", action="store_true",
                    help="also measure the serving scheduler's whole-plan "
                         "vs split-probe dispatch crossover and fit "
                         "morsel_split_rows")
    ap.add_argument("--morsel-probes", type=int, nargs="+",
                    default=[1 << b for b in range(8, 17, 2)],
                    help="probe sizes to sweep for the --morsel crossover")
    ap.add_argument("--morsel-pools", type=int, default=2)
    ap.add_argument("--morsel-workers", type=int, default=2)
    ap.add_argument("--sweep-groups", action="store_true",
                    help="also sweep n_groups to fit dense_group_limit and "
                         "the partitioned-layout capacity factor")
    ap.add_argument("--groups-sweep", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096, 8192, 16384],
                    help="group domains for the --sweep-groups crossover")
    ap.add_argument("--capacity-factors", type=float, nargs="+",
                    default=[1.0, 1.25, 1.5, 2.0, 3.0],
                    help="candidate partition capacity factors "
                         "(--sweep-groups fits the smallest overflow-free)")
    ap.add_argument("--refresh", metavar="PROFILE.json", default=None,
                    help="telemetry-refresh mode: run a recorded "
                         "representative workload on a virtual mesh and "
                         "rewrite the profile's drifting entries "
                         "(dist_route_factor / compact_margin / "
                         "filter_selectivity); all other sweeps are skipped")
    ap.add_argument("--dist-devices", type=int, default=8,
                    help="virtual shards of the --dist and --exchange "
                         "sweeps (--refresh takes at most 4)")
    ap.add_argument("--dist-probe", type=int, default=1 << 17,
                    help="probe rows for the distributed-join sweep")
    ap.add_argument("--dist-builds", type=int, nargs="+",
                    default=[1 << b for b in range(10, 18, 2)],
                    help="build-side sizes to sweep for the crossover")
    ap.add_argument("--out", default="cost_profile.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.refresh:
        refresh_from_telemetry(args.refresh, min(args.dist_devices, 4), dev)
        return 0

    N, G = args.rows, args.groups
    cols = sorted(set(args.cols))
    xla_runs, t_dense, t_sort, attempts = measure_base(N, G, cols,
                                                       args.mode, dev)
    t_xla = {C: median(r) for C, r in xla_runs.items()}
    profile = fit_base(cols, t_xla, t_dense, t_sort, N)
    pass_time_us = profile.pop("pass_time_us")
    profile.update({
        "backend": dev.type,
        "n_rows": N,
        "n_groups": G,
        "pass_time_us": pass_time_us,
        "raw_us": {
            "xla": {str(C): round(t_xla[C] * 1e6, 1) for C in cols},
            "dense": {str(C): round(t_dense[C] * 1e6, 1) for C in cols},
            "sort": round(t_sort * 1e6, 1),
            # every timed run of the baseline, so a reader can hold the
            # per-pass slope against the spread of its own points
            "xla_runs": {str(C): [round(t * 1e6, 1) for t in xla_runs[C]]
                         for C in cols},
        },
        # every attempt at the baseline: its slope and the largest
        # quartile spread of its widths' runs
        "base_attempts": [{"slope_us": round(a * 1e6, 3),
                           "spread_us": round(b * 1e6, 1)}
                          for a, b in attempts],
    })
    if dev.type == "cuda":
        profile["card"] = card_line(dev)
    if args.sweep_groups:
        fit = sweep_groups(N, args.groups_sweep, max(cols), args.mode,
                           args.capacity_factors, dev)
        profile["dense_group_limit"] = fit["dense_group_limit"]
        profile["partition_capacity_factor"] = \
            fit["partition_capacity_factor"]
        profile["raw_us"]["groups_sweep"] = fit["raw"]
    if args.dist:
        factor, raw_dist = calibrate_dist(args.dist_probe, args.dist_builds,
                                          args.dist_devices, dev)
        profile["dist_route_factor"] = factor
        profile["dist_probe"] = args.dist_probe
        profile["dist_devices"] = args.dist_devices
        profile["raw_us"]["dist_join"] = raw_dist
    if args.exchange:
        factor, raw_ex = calibrate_exchange(
            args.exchange_probes, args.exchange_build, args.dist_devices,
            profile["sort_pass_factor"], dev)
        profile["radix_route_factor"] = factor
        profile["exchange_build"] = args.exchange_build
        profile["raw_us"]["exchange_impl"] = raw_ex
    if args.morsel:
        threshold, raw_morsel = calibrate_morsel(
            args.morsel_probes, args.morsel_pools, args.morsel_workers, dev)
        profile["morsel_split_rows"] = threshold
        profile["morsel_pools"] = args.morsel_pools
        profile["raw_us"]["morsel_split"] = raw_morsel

    with open(args.out, "w") as f:
        json.dump(profile, f, indent=2)
        f.write("\n")
    print(json.dumps(profile, indent=2))
    print(f"\nwrote {args.out}; install with "
          f"planner.load_cost_profile({args.out!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
