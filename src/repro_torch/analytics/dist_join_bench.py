"""The distributed-join microbenchmarks: the port of
``repro.analytics.dist_join_bench``.

The reference builds each measurement as a source template run in a child
process with N fake XLA devices, because jax fixes its device count at
import. The port's mesh lives in-process (``core/vmesh.py``), so each
template is a plain function here, with ``n_shards`` in place of the
child's device count and the tables on ``device`` (the CUDA device unless
the caller names another). Each function returns the dict the reference's
child prints, with the same keys, from the same seeds, the same numpy
draws in the same order and the same plans.

One copy matters: the cost constants that ``scripts/calibrate_costs_torch.py
--dist`` and ``--exchange`` fit are only meaningful if the calibration
measures exactly what the planner's cost model prices, so the script and
``chip_smoke.py`` both call these functions and time with ``bench``.

  sweep     broadcast vs key-partitioned join at a sweep of build sizes
            (fits ``dist_route_factor``);
  exchange  the partitioned join with the hash Exchange's routing layout
            forced to the stable argsort and to the radix histograms at a
            sweep of probe sizes, plus the cost model's pick and the
            plan's estimated moved rows (fits ``radix_route_factor``);
  pushdown  one distributed group-by, aggregate push-down on vs off;
  chain     two chained partitioned joins, occupancy-aware Compact on vs
            off, with the largest routed buffer of each plan;
  topk      a distributed order-by-limit, TopK replicated vs candidates
            (bit-identity checked), with the candidate Exchange's
            estimated and telemetry-observed wire rows.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, Union

import numpy as np
import torch

from repro_torch.analytics import physical as PH
from repro_torch.analytics import plan as L
from repro_torch.analytics import planner, telemetry
from repro_torch.core.config import PlacementPolicy, resolve_device

Device = Union[None, str, torch.device]


def sync(device: torch.device) -> None:
    """Wait for the work issued on ``device``: a device-wide synchronize
    on a CUDA device; CPU results are ready when returned."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_runs(fn, *args, device: torch.device, warmup: int = 1,
               iters: int = 5) -> list:
    """Sorted host seconds of ``iters`` calls of ``fn(*args)`` after
    ``warmup`` untimed ones, each call ended by ``sync(device)`` (the wall
    a caller pays, host issue included)."""
    for _ in range(warmup):
        fn(*args)
        sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)


def bench(fn, *args, device: torch.device, iters: int = 5) -> float:
    """Median microseconds of ``fn(*args)`` (``bench_runs``)."""
    ts = bench_runs(fn, *args, device=device, iters=iters)
    return ts[len(ts) // 2] * 1e6


def probe_exchange(phys: PH.PhysicalPlan) -> PH.Exchange:
    """The largest keyed hash Exchange: the probe side's routing pass."""
    return max((n for n in PH.walk_unique(phys.root)
                if isinstance(n, PH.Exchange) and n.key is not None),
               key=lambda n: n.rows)


def max_buffer(phys: PH.PhysicalPlan) -> int:
    """Rows of the largest routed buffer the plan materializes."""
    return max(n.rows for n in PH.walk_unique(phys.root)
               if isinstance(n, PH.Exchange) and n.key is not None)


def _join_plan() -> L.LogicalPlan:
    return L.LogicalPlan(
        L.scan("probe").join(L.scan("build"), "pk", "bk", {"_v": "bv"})
        .aggregate(None, 1, count=("count", "_v"), checksum=("sum", "_v")),
        ("count", "checksum"))


def _tensors(tables, dev) -> Dict:
    """{table: {column: numpy array}} as tensors on ``dev``."""
    return {t: {c: torch.from_numpy(a).to(dev) for c, a in cols.items()}
            for t, cols in tables.items()}


def _join_tables(rng, probe_n: int, build_n: int, dev) -> Dict:
    probe = rng.randint(0, build_n, probe_n).astype(np.int32)
    bk = rng.permutation(build_n).astype(np.int32)
    bv = rng.rand(build_n).astype(np.float32)
    return _tensors({"probe": {"pk": probe}, "build": {"bk": bk, "bv": bv}},
                    dev)


def _check_no_overflow(out, tag: str) -> None:
    if int(out["_overflow"]) != 0:
        raise AssertionError(f"{tag}: {int(out['_overflow'])} rows "
                             "overflowed")


def sweep(probe: int, builds: Iterable[int], n_shards: int,
          device: Device = None) -> Dict[str, Dict[str, float]]:
    """{str(build_n): {"broadcast": us, "partitioned": us}}: a fixed-size
    probe joined against each build size under each forced
    ``dist_join`` strategy."""
    dev = resolve_device(device)
    rng = np.random.RandomState(7)
    lplan = _join_plan()
    res = {}
    for build_n in sorted(builds):
        tables = _join_tables(rng, probe, build_n, dev)
        row = {}
        for strat in ("broadcast", "partitioned"):
            ctx = planner.ExecutionContext(
                executor="xla", n_shards=n_shards,
                policy=PlacementPolicy.FIRST_TOUCH, dist_join=strat)
            cp = planner.compile_plan(lplan, tables, ctx)
            row[strat] = bench(cp, tables, device=dev)
        res[str(build_n)] = row
    return res


def exchange(build: int, probes: Iterable[int], n_shards: int,
             device: Device = None) -> Dict[str, Dict]:
    """{str(probe_n): {"argsort": us, "radix": us, "cost_picks": impl,
    "moved_rows": rows}}: one partitioned join with the Exchange routing
    layout forced each way, plus the cost model's static pick and the
    plan's estimated moved rows at that point."""
    dev = resolve_device(device)
    rng = np.random.RandomState(17)
    lplan = _join_plan()
    res = {}
    for probe_n in sorted(probes):
        tables = _join_tables(rng, probe_n, build, dev)
        row = {}
        for impl in ("argsort", "radix"):
            ctx = planner.ExecutionContext(
                executor="xla", n_shards=n_shards,
                policy=PlacementPolicy.FIRST_TOUCH, dist_join="partitioned",
                exchange_impl=impl)
            cp = planner.compile_plan(lplan, tables, ctx)
            row[impl] = bench(cp, tables, device=dev)
        ctx = planner.ExecutionContext(
            executor="xla", n_shards=n_shards,
            policy=PlacementPolicy.FIRST_TOUCH, dist_join="partitioned",
            exchange_impl="cost")
        ex = probe_exchange(planner.compile_plan(lplan, tables, ctx).physical)
        row["cost_picks"] = ex.impl
        row["moved_rows"] = ex.moved_rows
        res[str(probe_n)] = row
    return res


def pushdown(rows: int, groups: int, n_shards: int,
             device: Device = None) -> Dict[str, Dict]:
    """{"pushdown" | "no_pushdown": {"us", "moved_rows"}}: one distributed
    group-by with aggregate push-down forced on and off."""
    dev = resolve_device(device)
    rng = np.random.RandomState(11)
    k = rng.randint(0, groups, rows).astype(np.int32)
    v = rng.rand(rows).astype(np.float32)
    w = rng.rand(rows).astype(np.float32)
    tables = _tensors({"t": {"k": k, "v": v, "w": w}}, dev)
    lplan = L.LogicalPlan(
        L.scan("t").aggregate("k", groups, s=("sum", "v"), s2=("sum", "w"),
                              a=("avg", "v"), c=("count", "v")),
        ("s", "s2", "a", "c", "_overflow"))
    res = {}
    for tag, pd in (("pushdown", True), ("no_pushdown", False)):
        ctx = planner.ExecutionContext(executor="xla", n_shards=n_shards,
                                       policy=PlacementPolicy.INTERLEAVE,
                                       agg_pushdown=pd)
        cp = planner.compile_plan(lplan, tables, ctx)
        _check_no_overflow(cp(tables), tag)
        res[tag] = {"us": bench(cp, tables, device=dev),
                    "moved_rows": PH.moved_rows(cp.physical.root)}
    return res


def chain(rows: int, dim: int, n_shards: int,
          device: Device = None) -> Dict[str, Dict]:
    """{"compact" | "no_compact": {"us", "max_buffer_rows"}}: two chained
    partitioned joins with the occupancy-aware Compact pass on and off."""
    dev = resolve_device(device)
    rng = np.random.RandomState(13)
    k1 = rng.randint(0, dim, rows).astype(np.int32)
    k2 = rng.randint(0, dim, rows).astype(np.int32)
    pk1 = rng.permutation(dim).astype(np.int32)
    v1 = rng.rand(dim).astype(np.float32)
    pk2 = rng.permutation(dim).astype(np.int32)
    v2 = rng.rand(dim).astype(np.float32)
    tables = _tensors({"fact": {"k1": k1, "k2": k2},
                       "d1": {"pk1": pk1, "v1": v1},
                       "d2": {"pk2": pk2, "v2": v2}}, dev)
    node = L.scan("fact").join(L.scan("d1"), "k1", "pk1", {"_v1": "v1"})
    node = node.join(L.scan("d2"), "k2", "pk2", {"_v2": "v2"})
    lplan = L.LogicalPlan(
        node.aggregate(None, 1, c=("count", "_v2"), s=("sum", "_v2")),
        ("c", "s", "_overflow"))
    res = {}
    for tag, compact in (("compact", None), ("no_compact", False)):
        ctx = planner.ExecutionContext(executor="xla", n_shards=n_shards,
                                       policy=PlacementPolicy.INTERLEAVE,
                                       dist_join="partitioned",
                                       compact=compact)
        cp = planner.compile_plan(lplan, tables, ctx)
        _check_no_overflow(cp(tables), tag)
        res[tag] = {"us": bench(cp, tables, device=dev),
                    "max_buffer_rows": max_buffer(cp.physical)}
    return res


def topk(rows: int, groups: int, k: int, n_shards: int,
         device: Device = None) -> Dict:
    """A distributed order-by-limit with the TopK lowering forced to
    replicated and to candidates (the two must give the same bits): us of
    each, the candidate Exchange's estimated (``moved_rows``, k*(n-1))
    and telemetry-observed (``observed_moved``, k*(n-1)*n in all) wire
    rows, the cost model's pick and the wire budget k*n."""
    dev = resolve_device(device)
    rng = np.random.RandomState(19)
    keys = rng.randint(0, groups, rows).astype(np.int32)
    vals = rng.rand(rows).astype(np.float32)
    tables = _tensors({"t": {"k": keys, "v": vals}}, dev)
    lplan = L.LogicalPlan(
        L.scan("t").aggregate("k", groups, c=("count", "v"), s=("sum", "v"))
        .top_k("c", k, "top_idx"), ("c", "top_idx"))
    res: Dict = {}
    outs = {}
    for mode in ("replicated", "candidates"):
        ctx = planner.ExecutionContext(executor="xla", n_shards=n_shards,
                                       policy=PlacementPolicy.INTERLEAVE,
                                       dist_topk=mode)
        cp = planner.compile_plan(lplan, tables, ctx)
        outs[mode] = cp(tables)
        res[mode] = bench(cp, tables, device=dev)
        if mode == "candidates":
            res["moved_rows"] = cp.physical.root.child.moved_rows
            with telemetry.recording() as reg:
                tcp = planner.compile_plan(lplan, tables, ctx)
                tcp(tables)
            ps = reg.get(tcp.cache_key)
            nodes = ps.node_list()
            ex = tcp.physical.root.child
            ns = [s for i, s in ps.nodes.items() if nodes[i] is ex][0]
            res["observed_moved"] = ns.last["moved"]
    for key in ("c", "top_idx"):
        if not torch.equal(outs["replicated"][key],
                           outs["candidates"][key]):
            raise AssertionError(f"TopK {key}: candidates differ from "
                                 "replicated")
    res["cost_picks"] = planner.choose_dist_topk(
        groups, k, n_shards, planner.ExecutionContext())
    res["wire_budget"] = k * n_shards
    return res
