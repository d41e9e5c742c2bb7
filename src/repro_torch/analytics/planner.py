"""Cost-based physical planner: the port of ``repro.analytics.planner``.

  logical plan  --lower(plan, ctx)-->  PHYSICAL PLAN  --walk-->  operators

``lower`` turns each logical node into an explicit physical operator
(physical.py) with every strategy decision resolved to a plain field, from
static shape metadata and the ``ExecutionContext``:

  Aggregate   -> plain segment ops ("xla") | dense-chunked fused kernel |
                 range-partitioned fused kernel (``choose_aggregate``)
  Join        -> sorted-index searchsorted gather (build argsorts pooled by
                 ``JoinIndexPool``) | the join_probe kernel where the
                 context forces it (``choose_join``)

With ``ExecutionContext(n_shards=n, policy=P)`` the plan lowers for n
shards under placement policy P (Exchange, Compact and per-policy merges)
and runs on a virtual mesh of n shards on the tables' device
(``core/vmesh.py``): ``_DistributedExecutor`` walks the same tree on every
shard and calls the engine's collectives (engine.py). Without shards,
``_LocalExecutor`` walks it on one device. The reference's ``jax.jit``
becomes an eager callable, held with its physical plan in the bounded LRU
plan cache.

Under ``telemetry.recording()`` the walkers also note observed rows per
node, ``CompiledPlan`` folds them into the StatsRegistry, and a cache hit
on a drifting plan re-lowers with the observed join inputs
(``_maybe_replan``); ``explain_analyze`` renders them. Under
``tracing.tracing()`` compiles and dispatches leave host-side spans.

The cost model, in equivalent passes over the input rows:

  cost(xla)         = C
  cost(dense)       = 1.2 + 0.45 * C    (valid iff n_groups <=
                                         profile.dense_group_limit)
  cost(partitioned) = cost(dense) + 0.25 * log2(n_rows)
"""
from __future__ import annotations

import functools
import json
import math
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.analytics import physical as PH
from repro_torch.analytics import plan as L
from repro_torch.analytics import telemetry, tracing
from repro_torch.analytics.columnar import (DENSE_GROUP_LIMIT, Table,
                                            finalize_stacked,
                                            group_aggregate, pkfk_join,
                                            pkfk_join_kernel,
                                            segment_distinct, segment_median,
                                            segment_order_stat,
                                            segment_quantile,
                                            stacked_columns,
                                            stacked_group_sums)
from repro_torch.analytics.engine import (compact_routed_rows, gather_rows,
                                          interleave_group_median,
                                          interleave_group_sums,
                                          merge_partial_table,
                                          placed_group_median,
                                          pushdown_group_sums,
                                          radix_route_table_rows,
                                          replicated_group_median,
                                          route_owner, route_table_rows,
                                          routing_capacity)
from repro_torch.analytics.plan import (holistic_selector, is_holistic,
                                        parse_quantile)
from repro_torch.core.config import PlacementPolicy
from repro_torch.core.vmesh import Communicator, VirtualMesh, shard_rows


# ---------------------------------------------------------------------------
# execution context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExecutionContext:
    """Everything the planner may vary without touching the logical plan.

    The reference's fields, with its jax ``Mesh`` and ``axis`` replaced by
    ``n_shards``: None runs on one device, an int runs the plan on a
    virtual mesh of that many shards under ``policy``.
    ``executor``: "xla" forces segment ops, "kernel" the fused sweeps,
    "cost" lets the cost model choose. ``join``: None = cost-based, or
    force "sorted" / "kernel". ``mode``: kernel mode ("auto" | "cuda" |
    "ref", kernels.common). See ``repro.analytics.planner.ExecutionContext``
    for the distributed knobs."""

    executor: str = "cost"
    mode: Optional[str] = None               # kernel mode
    n_shards: Optional[int] = None
    policy: Optional[PlacementPolicy] = None
    join: Optional[str] = None
    n_partitions: int = 64
    capacity_factor: float = 2.0
    dist_join: Optional[str] = None
    dist_route: str = "hash"
    exchange_impl: str = "cost"
    dist_topk: str = "cost"
    agg_pushdown: Optional[bool] = None
    route_once: bool = True
    compact: Union[None, bool, int, float] = None

    def __post_init__(self):
        if self.executor not in ("xla", "kernel", "cost"):
            raise ValueError(f"unknown executor {self.executor!r}")
        if self.join not in (None, "sorted", "kernel"):
            raise ValueError(f"unknown join strategy {self.join!r}")
        if self.dist_join not in (None, "broadcast", "partitioned"):
            raise ValueError(
                f"unknown distributed join strategy {self.dist_join!r}")
        if self.dist_route not in ("hash", "modulo"):
            raise ValueError(f"unknown routing method {self.dist_route!r}")
        if self.exchange_impl not in ("argsort", "radix", "cost"):
            raise ValueError(
                f"unknown exchange impl {self.exchange_impl!r}")
        if self.dist_topk not in ("cost", "replicated", "candidates"):
            raise ValueError(
                f"unknown distributed TopK lowering {self.dist_topk!r}")
        if self.n_shards is not None and self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if (not isinstance(self.compact, bool) and self.compact is not None
                and (not isinstance(self.compact, (int, float))
                     or self.compact < 1.0)):
            raise ValueError("compact must be None, a bool, or a numeric "
                             f"margin >= 1.0; got {self.compact!r}")

    def cache_key(self) -> Tuple:
        # compact keys by its RESOLVED margin: True, None and 1.5 lower to
        # identical plans, while True == 1 == 1.0 would collide margins
        return (self.executor, self.mode, self.n_shards, self.policy,
                self.join, self.n_partitions, self.capacity_factor,
                self.dist_join, self.dist_route, self.exchange_impl,
                self.dist_topk, self.agg_pushdown, self.route_once,
                self.compact_margin())

    def compact_margin(self) -> Optional[float]:
        """Occupancy headroom for Compact nodes, or None when disabled."""
        if self.compact is False:
            return None
        if self.compact is None or self.compact is True:
            return COMPACT_MARGIN
        return float(self.compact)


# ---------------------------------------------------------------------------
# cost model (the constants are the reference's, set for its TPU;
# scripts/calibrate_costs_torch.py fits the H100's into a profile that
# load_cost_profile installs)
# ---------------------------------------------------------------------------
FUSED_FIXED = 1.2
FUSED_PER_COL = 0.45
SORT_PASS_FACTOR = 0.25
DIST_ROUTE_FACTOR = 1.5
COMPACT_MARGIN = 1.5
RADIX_ROUTE_FACTOR = 2.5
FILTER_SELECTIVITY = 0.75
MORSEL_SPLIT_ROWS = 2048


@dataclass(frozen=True)
class CostProfile:
    """Pass-equivalent cost constants (hand-set defaults or a measured
    profile). Frozen/hashable: the active profile is part of the
    plan-cache key."""

    fused_fixed: float = FUSED_FIXED
    fused_per_col: float = FUSED_PER_COL
    sort_pass_factor: float = SORT_PASS_FACTOR
    dist_route_factor: float = DIST_ROUTE_FACTOR
    radix_route_factor: float = RADIX_ROUTE_FACTOR
    filter_selectivity: float = FILTER_SELECTIVITY
    dense_group_limit: int = DENSE_GROUP_LIMIT
    morsel_split_rows: int = MORSEL_SPLIT_ROWS
    partition_capacity_factor: Optional[float] = None
    compact_margin: Optional[float] = None
    source: str = "builtin"


_COST_PROFILE = CostProfile()
_COST_PROFILE_LOCK = threading.Lock()


def current_cost_profile() -> CostProfile:
    return _COST_PROFILE


def set_cost_profile(profile: Optional[CostProfile]) -> CostProfile:
    """Install a cost profile (None restores the hand-set defaults)."""
    global _COST_PROFILE
    with _COST_PROFILE_LOCK:
        _COST_PROFILE = profile or CostProfile()
    return _COST_PROFILE


def load_cost_profile(path: str) -> CostProfile:
    """Install measured constants from a JSON file in the format
    ``scripts/calibrate_costs.py`` writes."""
    with open(path) as f:
        raw = json.load(f)
    pcf = raw.get("partition_capacity_factor")
    cm = raw.get("compact_margin")
    return set_cost_profile(CostProfile(
        compact_margin=(None if cm is None else float(cm)),
        fused_fixed=float(raw["fused_fixed"]),
        fused_per_col=float(raw["fused_per_col"]),
        sort_pass_factor=float(raw.get("sort_pass_factor", SORT_PASS_FACTOR)),
        dist_route_factor=float(raw.get("dist_route_factor",
                                        DIST_ROUTE_FACTOR)),
        radix_route_factor=float(raw.get("radix_route_factor",
                                         RADIX_ROUTE_FACTOR)),
        filter_selectivity=float(raw.get("filter_selectivity",
                                         FILTER_SELECTIVITY)),
        dense_group_limit=int(raw.get("dense_group_limit",
                                      DENSE_GROUP_LIMIT)),
        morsel_split_rows=int(raw.get("morsel_split_rows",
                                      MORSEL_SPLIT_ROWS)),
        partition_capacity_factor=(None if pcf is None else float(pcf)),
        source=str(raw.get("backend", path))))


def aggregate_costs(n_rows: int, n_groups: int, n_cols: int,
                    profile: Optional[CostProfile] = None
                    ) -> Dict[str, float]:
    """Pass-equivalent cost of each physical Aggregate layout."""
    p = profile or _COST_PROFILE
    fused = p.fused_fixed + p.fused_per_col * n_cols
    return {
        "xla": float(n_cols),
        "dense": fused if n_groups <= p.dense_group_limit else math.inf,
        "partitioned": fused + p.sort_pass_factor * math.log2(max(n_rows, 2)),
    }


def choose_aggregate(n_rows: int, n_groups: int, n_cols: int,
                     executor: str = "cost",
                     profile: Optional[CostProfile] = None) -> str:
    """Physical layout for one Aggregate: "xla" | "dense" | "partitioned"."""
    p = profile or _COST_PROFILE
    if executor == "xla":
        return "xla"
    if executor == "kernel":
        return "dense" if n_groups <= p.dense_group_limit else "partitioned"
    costs = aggregate_costs(n_rows, n_groups, n_cols, p)
    return min(costs, key=costs.get)


def choose_join(n_probe: int, n_build: int, ctx: ExecutionContext) -> str:
    """"sorted" (searchsorted gather) vs "kernel" (join_probe probe).

    The reference takes the kernel only where the MXU runs it. On the H100
    the kernel is a hashed probe per partition, 0.17 ms at q3's SF1 join,
    but the partition layout around it (two stable argsorts,
    ``pad_partitions``, the scatter back in ``pkfk_join_kernel``) costs
    more than the whole sorted plan: q3 takes 8.8 ms with the kernel forced
    and 2.7-2.9 ms on the sorted gather (NVIDIA H100 80GB HBM3, 700 W;
    ``chip_smoke.py``, PERF.md). So the port takes "sorted" unless
    ``ctx.join`` forces "kernel"."""
    del n_probe, n_build
    return ctx.join or "sorted"


def dist_join_costs(n_probe: int, n_build: int, n_shards: int,
                    profile: Optional[CostProfile] = None
                    ) -> Dict[str, float]:
    """Row-transfer-equivalent cost of each distributed Join lowering:
    broadcast ships n_build * (n-1) rows, partitioned routes both sides
    ((n_probe + n_build) * (n-1)/n) times the routing-layout factor."""
    p = profile or _COST_PROFILE
    n = max(int(n_shards), 2)
    return {
        "broadcast": float(n_build) * (n - 1),
        "partitioned": (float(n_probe) + float(n_build)) * (n - 1) / n
                       * p.dist_route_factor,
    }


def choose_dist_join(n_probe: int, n_build: int, n_shards: int,
                     ctx: ExecutionContext,
                     profile: Optional[CostProfile] = None) -> str:
    """"broadcast" vs "partitioned" for one distributed Join."""
    if ctx.dist_join is not None:
        return ctx.dist_join
    if n_shards < 2:
        return "broadcast"
    costs = dist_join_costs(n_probe, n_build, n_shards, profile)
    return min(costs, key=costs.get)


def exchange_costs(n_rows: int, profile: Optional[CostProfile] = None
                   ) -> Dict[str, float]:
    """Layout cost of each hash-Exchange routing impl for ``n_rows``
    per-shard routed rows: a stable argsort vs a flat radix pass."""
    p = profile or _COST_PROFILE
    return {
        "argsort": p.sort_pass_factor * math.log2(max(n_rows, 2)),
        "radix": p.radix_route_factor,
    }


def choose_exchange_impl(n_rows: int, ctx: ExecutionContext,
                         profile: Optional[CostProfile] = None) -> str:
    """"argsort" vs "radix" for one key-routing hash Exchange."""
    if ctx.exchange_impl != "cost":
        return ctx.exchange_impl
    costs = exchange_costs(n_rows, profile)
    return min(costs, key=costs.get)


def topk_costs(n_groups: int, k: int, n_shards: int,
               profile: Optional[CostProfile] = None) -> Dict[str, float]:
    """Row-transfer-equivalent cost of each distributed TopK lowering:
    replicating the group table vs converging k candidates per shard."""
    del profile
    n = max(int(n_shards), 2)
    return {
        "replicated": float(n_groups) * (n - 1) / n,
        "candidates": float(k) * n,
    }


def choose_dist_topk(n_groups: int, k: int, n_shards: int,
                     ctx: ExecutionContext,
                     profile: Optional[CostProfile] = None) -> str:
    """"replicated" vs "candidates" for one distributed TopK."""
    if ctx.dist_topk != "cost":
        return ctx.dist_topk
    if n_shards < 2:
        return "replicated"
    costs = topk_costs(n_groups, k, n_shards, profile)
    return min(costs, key=costs.get)


def stacked_width(aggs: Tuple[Tuple[str, Tuple[str, str]], ...]) -> int:
    """Width of the stacked values matrix: weights + distinct sum/avg."""
    return 1 + len({c for _, (op, c) in aggs if op in ("sum", "avg")})


def _stacked_src(aggs) -> list:
    """Distinct sum/avg source columns, insertion order: the static twin
    of the ``src`` list stacked_columns derives from data."""
    src: list = []
    for _name, (op, c) in aggs:
        if op in ("sum", "avg") and c not in src:
            src.append(c)
    return src


@dataclass(frozen=True)
class Decision:
    """One planner choice, for ``explain`` output and tests."""
    node: str
    detail: str
    choice: str
    costs: Optional[Tuple[Tuple[str, float], ...]] = None

    def describe(self) -> str:
        c = ""
        if self.costs:
            c = " (" + ", ".join(f"{k}={v:.2f}" for k, v in self.costs) + ")"
        return f"{self.node}[{self.detail}] -> {self.choice}{c}"


# ---------------------------------------------------------------------------
# bounded LRU plan cache
# ---------------------------------------------------------------------------
class CacheInfo(NamedTuple):
    hits: int
    misses: int
    maxsize: int
    currsize: int


class LRUCache:
    """Bounded LRU, safe for concurrent get/put/evict (one re-entrant
    lock around every mutation and the hit/miss counters)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get(self, key):
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def resize(self, maxsize: int) -> None:
        with self._lock:
            self.maxsize = maxsize
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.hits = self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def info(self) -> CacheInfo:
        with self._lock:
            return CacheInfo(self.hits, self.misses, self.maxsize,
                             len(self._d))


DEFAULT_PLAN_CACHE_ENTRIES = 64
_PLAN_CACHE = LRUCache(DEFAULT_PLAN_CACHE_ENTRIES)


def configure_plan_cache(max_entries: int) -> None:
    """Bound the plan LRU (evicts oldest immediately if needed)."""
    if max_entries < 1:
        raise ValueError("plan cache needs at least one entry")
    _PLAN_CACHE.resize(max_entries)


def plan_cache_info() -> CacheInfo:
    return _PLAN_CACHE.info()


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


# ---------------------------------------------------------------------------
# join build-side index pool
# ---------------------------------------------------------------------------
class JoinIndexPool:
    """(order, sorted_keys) argsorts keyed on column-tensor IDENTITY.

    The key is ``id`` plus an identity check against a WEAK reference, so
    recycled ids never alias and the pool never keeps a dropped dataset
    alive on the device. Each index is built once and shared by every
    query that joins through the same build column.

    On a CUDA device an index is made on the building thread's stream and
    may be read on another (the serving tier's worker pools each issue on
    a stream of their own): each entry holds an event recorded after its
    build, and every fetch makes the caller's current stream wait on it
    and marks the tensors as used there (``record_stream``), so the
    allocator never hands their memory out while that stream may still
    read it."""

    def __init__(self, maxsize: int = 256):
        self._lru = LRUCache(maxsize)
        self.builds = 0
        self.replicas = 0

    def get(self, table: str, column: str,
            arr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (table, column, id(arr))
        hit = self._lru.get(key)
        if hit is not None and hit[0]() is arr:
            return _fetched(hit)
        # the argsort runs outside the lock: concurrent first-touchers may
        # both build (one entry survives), never blocking each other
        order = torch.argsort(arr, stable=True)
        idx = (order, arr[order])
        with self._lru._lock:
            self._lru.put(key, (weakref.ref(arr), idx, _built(arr.device)))
            self.builds += 1
            self._sweep_dead()
        return idx

    def replica(self, table: str, column: str, arr: torch.Tensor,
                pool_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A per-worker-pool copy of ``get``'s (order, sorted_keys) pair:
        the build-side replication of the paper's socket-local working
        sets. The base index is computed ONCE (``builds`` counts sorts);
        each pool then gets its own copy (``replicas`` counts them), made
        on the calling pool's current stream, so every probe morsel a pool
        runs reads a pool-local build structure. Values are bit-identical
        to the base index by construction."""
        key = (table, column, id(arr), "replica", int(pool_id))
        hit = self._lru.get(key)
        if hit is not None and hit[0]() is arr:
            return _fetched(hit)
        order, sk = self.get(table, column, arr)     # base: built once
        with self._lru._lock:
            # double-check under the lock: two workers of the SAME pool
            # can race their pool's first morsel, and "one replica per
            # pool" is the accounting invariant
            hit = self._lru.get(key)
            if hit is not None and hit[0]() is arr:
                return _fetched(hit)
            idx = (order.clone(), sk.clone())
            self._lru.put(key, (weakref.ref(arr), idx, _built(arr.device)))
            self.replicas += 1
            self._sweep_dead()
        return idx

    def _sweep_dead(self) -> None:
        with self._lru._lock:
            dead = [k for k, entry in self._lru._d.items()
                    if entry[0]() is None]
            for k in dead:
                del self._lru._d[k]

    def info(self) -> CacheInfo:
        return self._lru.info()

    def clear(self) -> None:
        self._lru.clear()
        self.builds = 0
        self.replicas = 0


def _built(device: torch.device) -> Optional["torch.cuda.Event"]:
    """An event on ``device``'s current stream after a build (None on the
    CPU, where there are no streams)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _fetched(entry) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pooled index, safe to read on the caller's current stream."""
    _ref, idx, ready = entry
    if ready is not None:
        stream = torch.cuda.current_stream(idx[0].device)
        stream.wait_event(ready)
        for t in idx:
            t.record_stream(stream)
    return idx


_INDEX_POOL = JoinIndexPool()


def join_index_pool() -> JoinIndexPool:
    return _INDEX_POOL


def required_indexes(root: L.Node) -> Tuple[Tuple[str, str], ...]:
    """(table, column) build-side sort indexes the plan's joins can use."""
    out: List[Tuple[str, str]] = []
    for node in L.walk(root):
        if isinstance(node, L.Join):
            sc = L.base_scan(node.build, node.build_key)
            if sc is not None and (sc.table, node.build_key) not in out:
                out.append((sc.table, node.build_key))
    return tuple(out)


# ---------------------------------------------------------------------------
# morsel-split probe analysis (the serving scheduler's split-probe oracle)
# ---------------------------------------------------------------------------
def _physical_base_scan(node: PH.PNode, column: str) -> Optional[PH.PScan]:
    """The PScan whose ``column`` reaches ``node`` value-identical (same
    rows, same order, never overwritten), or None: the physical twin of
    L.base_scan. It certifies that the pooled (order, sorted_keys) index
    built from the base table's column is valid for this node's Table.
    Filter only masks, a local Join's output rows ARE its probe rows,
    Project/Attach only add columns (unless they shadow ``column``)."""
    while True:
        if isinstance(node, PH.PScan):
            return node
        if isinstance(node, PH.PFilter):
            node = node.child
        elif isinstance(node, PH.PProject):
            if any(n == column for n, _ in node.cols):
                return None
            node = node.child
        elif isinstance(node, PH.PJoin):
            if node.dist is not None or any(n == column
                                            for n, _ in node.take):
                return None
            node = node.probe
        elif isinstance(node, PH.PAttach):
            if any(n == column for n, _ in node.cols):
                return None
            node = node.child
        else:
            return None


@dataclass(frozen=True)
class PreludeSpec:
    """One subtree of a split-probe plan that runs ONCE per task (not per
    morsel): a join build side or an Attach source. ``is_table`` says
    whether its result is a Table (handed to the morsels as (columns,
    mask)) or a dict of group tensors; ``index`` is the (table, column)
    pooled sort index a pool-local replica seeds into the rebuilt build
    Table's index_cache (None for Attach sources, which need none)."""
    node: PH.PNode
    is_table: bool
    index: Optional[Tuple[str, str]]


@dataclass(frozen=True)
class ProbeSplit:
    """probe_split()'s answer: what the serving scheduler needs to run a
    marked join-probe pipeline as per-pool morsels. ``scan`` is the
    probe-side base scan (the morsel axis), ``pipeline_root`` the
    aggregate's input (every node between scan and aggregate is per-row
    deterministic, so the morsel outputs concatenated in morsel order are
    the serial intermediate table bit for bit), ``preludes`` the
    once-per-task subtrees, ``root`` / ``outputs`` what the finalize step
    runs over the merged table."""
    root: PH.PNode
    outputs: Optional[Tuple[str, ...]]
    scan: PH.PScan
    pipeline_root: PH.PNode
    preludes: Tuple[PreludeSpec, ...]
    n_rows: int


def probe_split(phys: PH.PhysicalPlan) -> Optional[ProbeSplit]:
    """Decompose a LOCAL physical plan into a morsel-splittable probe
    pipeline, or None when the plan must run whole.

    Splittable = (optional PTopK over) a PAggregate whose child chain down
    to one PScan is Filter/Project/Join/Attach where EVERY join is
    ``morsel_split``-marked (sorted strategy, probe side past the
    cost-model crossover) with a resolvable base-scan build index. Each
    on-path operator is per-row deterministic over the probe rows, so a
    row-range slice of the scan yields exactly that slice of the serial
    intermediate table. Declines rather than degrade: an unresolvable
    build index would force a per-morsel argsort, and a kernel-strategy
    join changes overflow semantics under slicing."""
    if phys.n_shards != 1:
        return None
    node = phys.root
    while isinstance(node, PH.PTopK):
        node = node.child
    if not isinstance(node, PH.PAggregate):
        return None
    preludes: List[PreludeSpec] = []
    path: List[PH.PNode] = []
    cur = node.child
    while not isinstance(cur, PH.PScan):
        path.append(cur)
        if isinstance(cur, (PH.PFilter, PH.PProject)):
            cur = cur.child
        elif isinstance(cur, PH.PJoin):
            if not cur.morsel_split:
                return None          # cost model declined (or kernel join)
            base = _physical_base_scan(cur.build, cur.build_key)
            if base is None:
                return None          # no poolable build index: stay whole
            preludes.append(PreludeSpec(
                cur.build, True, (base.table, cur.build_key)))
            cur = cur.probe
        elif isinstance(cur, PH.PAttach):
            src = cur.source
            preludes.append(PreludeSpec(
                src, not isinstance(src, (PH.PAggregate, PH.PTopK)), None))
            cur = cur.child
        else:
            return None
    if not any(p.index is not None for p in preludes):
        return None                  # no join probe to parallelize
    scan = cur
    path.append(scan)
    # a prelude subtree structurally EQUAL to a path node would collide in
    # the executor's structural memo (the path is seeded with morsel
    # slices, the prelude with whole tables): decline such shapes
    path_set = set(path)
    if any(p.node in path_set for p in preludes):
        return None
    return ProbeSplit(phys.root, phys.outputs, scan, node.child,
                      tuple(preludes), scan.rows)


# ---------------------------------------------------------------------------
# expression evaluation
# ---------------------------------------------------------------------------
def eval_expr(e: L.Expr, table: Table):
    if isinstance(e, L.Col):
        return table.col(e.name)
    if isinstance(e, L.Lit):
        return e.value
    if isinstance(e, L.UnOp):
        v = eval_expr(e.operand, table)
        if e.op == "abs":
            return abs(v)
        if e.op == "neg":
            return -v
        if e.op == "not":
            return ~v
        raise ValueError(f"unknown unary op {e.op!r}")
    if isinstance(e, L.BinOp):
        a, b = eval_expr(e.lhs, table), eval_expr(e.rhs, table)
        ops = {"add": lambda: a + b, "sub": lambda: a - b,
               "mul": lambda: a * b, "div": lambda: a / b,
               "le": lambda: a <= b, "lt": lambda: a < b,
               "ge": lambda: a >= b, "gt": lambda: a > b,
               "eq": lambda: a == b, "ne": lambda: a != b,
               "and": lambda: a & b, "or": lambda: a | b}
        try:
            return ops[e.op]()
        except KeyError:
            raise ValueError(f"unknown binary op {e.op!r}") from None
    raise TypeError(f"not an expression: {e!r}")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values, ties broken by LOWEST index
    (``torch.topk`` promises no tie order). Indices are int32."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


# ---------------------------------------------------------------------------
# lowering: logical plan -> physical plan
# ---------------------------------------------------------------------------
def lower(plan: L.LogicalPlan, ctx: ExecutionContext,
          rows: Dict[str, int], profile: Optional[CostProfile] = None,
          n_shards: Optional[int] = None,
          observed=None) -> PH.PhysicalPlan:
    """Cost-driven lowering pass: resolve every strategy decision into an
    explicit physical tree, then let the movement rewrites (push-down,
    route-once, compaction — see module docstring) improve it.

    ``rows`` maps table name -> true row count (the shape signature the
    plan-cache key already carries). ``n_shards`` overrides the mesh width
    — lowering is pure shape arithmetic, so tests and explain can lower
    distributed plans without materializing fake devices. ``observed`` is
    the adaptive re-planning hook: an ``observed(probe_key, build_key) ->
    (probe_alive, build_alive) | None`` lookup (telemetry's recorded
    GLOBAL alive rows) consulted ONLY by the distributed-join cost choice
    — estimates and buffer shapes are untouched, so a re-lowering with
    unchanged decisions is structurally identical to the original."""
    profile = profile or current_cost_profile()
    if n_shards is None:
        distributed = ctx.n_shards is not None
        n_shards = ctx.n_shards if distributed else 1
    else:
        distributed = True
    lo = _Lowering(ctx, rows, profile, n_shards, distributed, observed)
    root = lo.node(plan.root)
    return PH.PhysicalPlan(root, plan.outputs,
                           n_shards if distributed else 1)


class _Lowering:
    """One lower() pass: shape propagation + strategy choice per node."""

    def __init__(self, ctx, rows, profile, n, distributed, observed=None):
        self.ctx = ctx
        self.rows = rows
        self.profile = profile
        self.n = n
        self.distributed = distributed
        self.observed = observed             # adaptive re-plan lookup
        margin = ctx.compact_margin()        # None = compaction disabled
        if ctx.compact is None and profile.compact_margin is not None:
            # context left the margin at its default: the profile's
            # telemetry-fitted margin replaces the hand-set constant
            margin = profile.compact_margin
        self.margin = margin

    def groups(self, card: L.Cardinality) -> int:
        if isinstance(card, L.TableRows):
            return self.rows[card.table]
        return int(card)

    def node(self, node: L.Node) -> PH.PNode:
        method = getattr(self, "_" + type(node).__name__.lower())
        return method(node)

    # -- relational nodes ---------------------------------------------------
    def _scan(self, node: L.Scan) -> PH.PScan:
        r = self.rows[node.table]
        per = (r + (-r % self.n)) // self.n if self.distributed else r
        return PH.PScan(node.table, rows=per, est=per)

    def _filter(self, node: L.Filter) -> PH.PNode:
        c = self.node(node.child)
        pushed = self._filter_below_exchange(c, node.pred)
        if pushed is not None:
            return pushed
        return PH.PFilter(c, node.pred, rows=c.rows, est=c.est)

    def _filter_below_exchange(self, c: PH.PNode,
                               pred: L.Expr) -> Optional[PH.PNode]:
        """Filter-below-Exchange peephole: a Filter over a partitioned
        PJoin whose predicate reads only PRE-ROUTE columns (none of the
        join's take columns, so every referenced column already exists on
        the probe side below its hash Exchange) is pushed beneath the
        probe routing. Rows the predicate kills become dead padding BEFORE
        the all-to-all — they re-route round-robin with zero weight — so
        the wire carries fewer alive rows, not just a cheaper layout.
        Results are bit-identical: the filter mask multiplies into the
        same selection weights either side of the routing, and dead rows
        can never match a join key or enter an aggregate. The Exchange's
        ``moved_rows`` estimate shrinks by the profile's
        filter_selectivity per pushed filter (capacity and est are
        untouched — occupancy budgets stay safe); telemetry's observed
        alive_in/alive_out refreshes the selectivity."""
        if not (self.distributed and isinstance(c, PH.PJoin)
                and c.dist == "partitioned"):
            return None
        ex = c.probe
        if not (isinstance(ex, PH.Exchange) and ex.kind == "hash"
                and ex.key is not None):
            return None
        cols = L.expr_cols(pred)
        if not cols or any(name in cols for name, _src in c.take):
            return None              # predicate reads a post-join column
        inner = PH.PFilter(ex.child, pred, rows=ex.child.rows,
                           est=ex.child.est, pushed=True)
        sel = self.profile.filter_selectivity ** PH.filters_below(inner)
        moved = int(ex.est * sel) * (self.n - 1) // self.n
        routed = PH.Exchange(inner, "hash", key=ex.key,
                             capacity=ex.capacity, method=ex.method,
                             rows=ex.rows, est=ex.est, moved_rows=moved,
                             impl=ex.impl)
        return PH.PJoin(routed, c.build, c.probe_key, c.build_key, c.take,
                        c.strategy, c.dist, rows=c.rows, est=c.est)

    def _project(self, node: L.Project) -> PH.PProject:
        c = self.node(node.child)
        return PH.PProject(c, node.cols, rows=c.rows, est=c.est)

    def _attach(self, node: L.Attach) -> PH.PAttach:
        c = self.node(node.child)
        src = self.node(node.source)
        return PH.PAttach(c, src, node.key, node.cols, rows=c.rows,
                          est=c.est)

    def _topk(self, node: L.TopK) -> PH.PTopK:
        c = self.node(node.child)
        if not self.distributed:
            return PH.PTopK(c, node.col, node.k, node.index_name,
                            rows=node.k, est=node.k)
        # distributed TopK: the child aggregate's merged group table is
        # replicated, so selecting on it directly ("replicated") is
        # correct but charges the TopK the table's replication. The
        # "candidates" lowering instead selects each shard's local top-k
        # over the ~G/n group slots it owns and converges only k rows per
        # shard through an explicit gather Exchange — k * n_shards
        # candidate rows on the wire, bit-identical results (within-shard
        # ties keep ascending global slot order, the shard-major gather
        # preserves it, and lax.top_k's lowest-index tie-break matches
        # the replicated selection).
        G = c.rows
        choice = choose_dist_topk(G, node.k, self.n, self.ctx, self.profile)
        if choice == "candidates":
            ex = PH.Exchange(c, "gather", rows=node.k * self.n,
                             est=node.k * self.n,
                             moved_rows=node.k * (self.n - 1))
            return PH.PTopK(ex, node.col, node.k, node.index_name,
                            dist="candidates", rows=node.k, est=node.k)
        return PH.PTopK(c, node.col, node.k, node.index_name,
                        dist="replicated", rows=node.k, est=node.k)

    # -- joins --------------------------------------------------------------
    def _join(self, node: L.Join) -> PH.PJoin:
        probe = self.node(node.probe)
        build = self.node(node.build)
        if not self.distributed:
            strategy = choose_join(probe.rows, build.rows, self.ctx)
            # morsel-splittable probe phase: the sorted-index gather is
            # per-probe-row deterministic against a fixed build index, so
            # the serving scheduler may slice the probe side into
            # per-pool morsels (build side replicated per pool) with
            # bit-identical results. The kernel join's partition-overflow
            # semantics change under row slicing, so only the sorted
            # strategy is markable; small probes stay whole-plan (the
            # per-morsel dispatch overhead loses below the fitted
            # morsel_split_rows crossover).
            split = (strategy == "sorted"
                     and probe.rows >= self.profile.morsel_split_rows)
            return PH.PJoin(probe, build, node.probe_key, node.build_key,
                            node.take, strategy, None,
                            rows=probe.rows, est=probe.est,
                            morsel_split=split)
        n_probe, n_build = probe.rows * self.n, build.rows * self.n
        if self.observed is not None:
            obs = self.observed(node.probe_key, node.build_key)
            if obs is not None:
                # re-plan: price the join from the alive rows execution
                # actually saw (filter selectivity, padding occupancy)
                # instead of the static physical buffer sizes
                n_probe, n_build = obs
        choice = choose_dist_join(n_probe, n_build,
                                  self.n, self.ctx, self.profile)
        if choice == "broadcast":
            b = PH.Exchange(build, "broadcast", rows=build.rows * self.n,
                            est=build.est * self.n,
                            moved_rows=build.rows * (self.n - 1))
            return PH.PJoin(probe, b, node.probe_key, node.build_key,
                            node.take, "sorted", "broadcast",
                            rows=probe.rows, est=probe.est)
        p_in = self._routed(probe, node.probe_key)
        b_in = self._routed(build, node.build_key)
        return PH.PJoin(p_in, b_in, node.probe_key, node.build_key,
                        node.take, "sorted", "partitioned",
                        rows=p_in.rows, est=probe.est)

    def _routed(self, side: PH.PNode, key: str) -> PH.PNode:
        """One partitioned-join side: route-once elision, else
        compact-then-hash-Exchange to the key's owner shards."""
        method = self.ctx.dist_route
        if (self.ctx.route_once
                and PH.placed_key(side) == (key, method)):
            return side              # rule 2: an upstream routing suffices
        side = PH.maybe_compact(
            side, self.margin or 0.0, self.margin is not None,
            self.profile.filter_selectivity
            ** PH.filters_below(side))                         # rule 3
        cap = routing_capacity(side.rows, self.n, self.ctx.capacity_factor)
        sel = self.profile.filter_selectivity ** PH.filters_below(side)
        return PH.Exchange(side, "hash", key=key, capacity=cap,
                           method=method, rows=self.n * cap, est=side.est,
                           moved_rows=int(side.est * sel)
                           * (self.n - 1) // self.n,
                           impl=choose_exchange_impl(side.rows, self.ctx,
                                                     self.profile))

    # -- aggregates ---------------------------------------------------------
    def _aggregate(self, node: L.Aggregate) -> PH.PAggregate:
        child = self.node(node.child)
        if node.key is None:
            merge = "scalar" if self.distributed else None
            return PH.PAggregate(child, None, 1, node.aggs, "xla", merge,
                                 None, rows=1, est=1)
        G = self.groups(node.n_groups)
        C = stacked_width(node.aggs)
        has_med = any(is_holistic(op) for _, (op, _c) in node.aggs)
        if not self.distributed:
            layout = choose_aggregate(child.rows, G, C, self.ctx.executor,
                                      self.profile)
            return PH.PAggregate(child, node.key, G, node.aggs, layout,
                                 None, None, rows=G, est=G)
        policy = self.ctx.policy or PlacementPolicy.FIRST_TOUCH
        if not has_med:
            med = None
        elif self.ctx.route_once and PH.routes_once(child, node.key):
            # rows already co-located by the group key (route-once): the
            # order statistic selects on the owner shard directly and the
            # merge is an owner-masked psum — O(G) wire rows instead of
            # re-routing O(N) records through a fresh Exchange
            med = "placed"
        else:
            med = ("route" if policy == PlacementPolicy.INTERLEAVE
                   else "replicate")
        dist_aggs = tuple((nm, oc) for nm, oc in node.aggs
                          if not is_holistic(oc[0]))
        if not dist_aggs:
            # holistic-only: counts come from the selection path, no
            # stacked-sums merge at all
            return PH.PAggregate(child, node.key, G, node.aggs, "xla",
                                 "holistic", med, rows=G, est=G)
        if policy in (PlacementPolicy.FIRST_TOUCH,
                      PlacementPolicy.LOCAL_ALLOC):
            layout = self._occupancy_safe(child, choose_aggregate(
                child.rows, G, C, self.ctx.executor, self.profile))
            partial = PH.PPartialAggregate(child, node.key, G, dist_aggs,
                                           layout, rows=G, est=G)
            # the merge collective is a first-class Exchange node, so
            # explain() prices EVERY policy's wire volume on the same
            # axis (pushdown already had one): FT's psum is a ring
            # allreduce over the (G, C) partial tables (reduce-scatter +
            # all-gather, ~2 G (n-1)/n partial rows on the wire), LA's
            # reduce_scatter is the first half only. Both execute FUSED
            # in PAggregate (merge_partial_table), like "gather".
            if policy == PlacementPolicy.FIRST_TOUCH:
                merge, kind = "psum", "allreduce"
                moved = 2 * G * (self.n - 1) // self.n
            else:
                merge, kind = "reduce_scatter", "reduce_scatter"
                moved = G * (self.n - 1) // self.n
            ex = PH.Exchange(partial, kind, rows=G, est=G,
                             moved_rows=moved)
            return PH.PAggregate(ex, node.key, G, node.aggs, layout,
                                 merge, med, rows=G, est=G)
        if policy == PlacementPolicy.PREFERRED:
            ex = PH.Exchange(child, "gather", rows=child.rows * self.n,
                             est=child.est * self.n,
                             moved_rows=child.rows * (self.n - 1))
            layout = self._occupancy_safe(child, choose_aggregate(
                child.rows * self.n, G, C, self.ctx.executor,
                self.profile))
            return PH.PAggregate(ex, node.key, G, node.aggs, layout,
                                 "gather", med, rows=G, est=G)
        return self._interleave_aggregate(node, child, G, C, dist_aggs, med)

    def _interleave_aggregate(self, node, child, G, C, dist_aggs, med):
        """INTERLEAVE grouped aggregation: route-once elision, push-down,
        or the record-routing Exchange — in that preference order."""
        ctx = self.ctx
        if ctx.route_once and PH.routes_once(child, node.key):
            # rule 2: rows already co-located by the group key — each
            # group's table is complete on one shard, merge is a psum of
            # disjoint tables. Records route ONE time, join + aggregate.
            layout = self._occupancy_safe(child, choose_aggregate(
                child.rows, G, C, ctx.executor, self.profile))
            return PH.PAggregate(child, node.key, G, node.aggs, layout,
                                 "placed", med, rows=G, est=G)
        # the push-down crossover is priced on the estimated ALIVE input
        # (est discounted by the telemetry-refreshed filter selectivity
        # per stacked filter), not the physical buffer rows: a heavily
        # filtered input ships fewer records than its buffer suggests,
        # which moves the G-vs-records crossover
        alive = max(int(child.est
                        * self.profile.filter_selectivity
                        ** PH.filters_below(child)), 1)
        pushdown = (ctx.agg_pushdown is True
                    or (ctx.agg_pushdown is None
                        and PH.pushdown_profitable(G, alive)))
        if pushdown:
            # rule 1: partial-aggregate below the exchange, ship ~G
            # partial rows instead of the records
            layout = self._occupancy_safe(child, choose_aggregate(
                child.rows, G, C, ctx.executor, self.profile))
            partial = PH.PPartialAggregate(child, node.key, G, dist_aggs,
                                           layout, rows=G, est=G)
            cap = routing_capacity(G, self.n, ctx.capacity_factor)
            ex = PH.Exchange(partial, "hash", key=None, capacity=cap,
                             rows=self.n * cap, est=G,
                             moved_rows=G * (self.n - 1) // self.n)
            return PH.PAggregate(ex, node.key, G, node.aggs, layout,
                                 "pushdown", med, rows=G, est=G)
        # record routing: the classic INTERLEAVE all-to-all of the data
        rchild = PH.maybe_compact(child, self.margin or 0.0,
                                  self.margin is not None,
                                  self.profile.filter_selectivity
                                  ** PH.filters_below(child))
        cap = routing_capacity(rchild.rows, self.n, ctx.capacity_factor)
        sel = self.profile.filter_selectivity ** PH.filters_below(rchild)
        ex = PH.Exchange(rchild, "hash", key=node.key, capacity=cap,
                         method="modulo", rows=self.n * cap, est=rchild.est,
                         moved_rows=int(rchild.est * sel)
                         * (self.n - 1) // self.n,
                         impl=choose_exchange_impl(rchild.rows, self.ctx,
                                                   self.profile))
        n_slots = (G + (-G % self.n)) // self.n
        layout = choose_aggregate(self.n * cap, n_slots + 1, C,
                                  ctx.executor, self.profile)
        if layout == "partitioned":
            # the routed buffer masses its padding on one drop slot; the
            # partitioned layout's capacity accounting counts those rows,
            # so fall back to the occupancy-independent segment ops
            layout = "xla"
        return PH.PAggregate(ex, node.key, G, node.aggs, layout, "owner",
                             med, rows=G, est=G)

    def _occupancy_safe(self, child: PH.PNode, layout: str) -> str:
        """Range-partitioned layouts size per-partition capacity from row
        COUNTS — on a routed buffer the padding would eat it (phantom
        overflow, dropped records), so fall back to segment ops there."""
        if layout == "partitioned" and PH.has_routed_buffer(child):
            return "xla"
        return layout



# ---------------------------------------------------------------------------
# physical execution: a thin walker over the physical IR
# ---------------------------------------------------------------------------
class _LocalExecutor:
    """Single-device walker over a physical plan.

    Memoization is by NODE STRUCTURE (physical nodes are frozen
    dataclasses), so structurally identical subtrees execute once.

    With ``record`` the walk notes per-node counters (telemetry.py) as
    device tensors, keyed by walk_unique id, and returns them under
    ``"_stats"``. Without it, no recording site runs: each sits behind
    ``if self.record``, so the walk makes no extra launch and no sync."""

    def __init__(self, tables, ctx: ExecutionContext, indexes,
                 profile: Optional[CostProfile] = None,
                 record: bool = False,
                 device: Optional[torch.device] = None):
        self.tables = tables
        self.ctx = ctx
        self.indexes = indexes           # {"table.column": (order, sk)}
        # fitted partitioned-layout capacity (profile) falls back to ctx
        self.agg_cf = ((profile.partition_capacity_factor
                        if profile is not None else None)
                       or ctx.capacity_factor)
        # ``device`` places an executor that has no tables (the serving
        # tier's split-probe finalize walks a merged table only)
        self.device = _device_of(tables) if tables else device
        self.overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        self._memo: Dict[PH.PNode, object] = {}
        self.record = record
        self.stats: Dict[int, Dict[str, Union[int, torch.Tensor]]] = {}
        self._ids: Dict[PH.PNode, int] = {}

    def run(self, node: PH.PNode):
        hit = self._memo.get(node)
        if hit is None:
            hit = self._eval(node)
            self._memo[node] = hit
        return hit

    def _note(self, node: PH.PNode, **vals) -> None:
        """Stash one node's observed counters (device scalars or Python
        ints; ``CompiledPlan`` reads them back in one transfer). Memoized
        subtrees note once, as they execute once."""
        i = self._ids.get(node)
        if i is not None:
            self.stats.setdefault(i, {}).update(vals)

    def _eval(self, node: PH.PNode):
        method = getattr(self, "_" + type(node).__name__.lower())
        return method(node)

    # -- node lowerings -----------------------------------------------------
    def _pscan(self, node: PH.PScan) -> Table:
        cols = dict(self.tables[node.table])
        cache = {}
        for (key, idx) in self.indexes.items():
            t, _, c = key.partition(".")
            if t == node.table and c in cols:
                cache[c] = idx
        return Table(cols, None, cache)

    def _pfilter(self, node: PH.PFilter) -> Table:
        t = self.run(node.child)
        out = t.filter(eval_expr(node.pred, t))
        self._record_filter(node, t, out)
        return out

    def _record_filter(self, node: PH.PFilter, t: Table,
                       out: Table) -> None:
        if self.record:
            # observed selectivity (alive_out / alive_in) is what
            # telemetry.refresh_profile fits filter_selectivity from
            self._note(node, alive_in=(t.weights() > 0).sum(),
                       alive_out=(out.weights() > 0).sum())

    def _pproject(self, node: PH.PProject) -> Table:
        t = self.run(node.child)
        return t.with_columns(**{n: eval_expr(e, t) for n, e in node.cols})

    def _pjoin(self, node: PH.PJoin) -> Table:
        probe = self.run(node.probe)
        build = self.run(node.build)
        if node.strategy == "kernel":
            joined, ovf = pkfk_join_kernel(
                probe, build, node.probe_key, node.build_key,
                dict(node.take), mode=self.ctx.mode,
                n_partitions=self.ctx.n_partitions,
                capacity_factor=self.ctx.capacity_factor)
            self.overflow = self.overflow + ovf
        else:
            joined = pkfk_join(probe, build, node.probe_key, node.build_key,
                               dict(node.take))
        self._record_join(node, probe, build, joined)
        return joined

    def _record_join(self, node: PH.PJoin, probe: Table, build: Table,
                     joined: Table) -> None:
        if self.record:
            self._note(node, out_alive=(joined.weights() > 0).sum())

    def _pattach(self, node: PH.PAttach) -> Table:
        t = self.run(node.child)
        src = self.run(node.source)
        first = src[node.cols[0][1]]
        pos = torch.clamp(t.col(node.key), 0, first.shape[0] - 1)
        return t.with_columns(**{new: src[s][pos] for new, s in node.cols})

    def _ptopk(self, node: PH.PTopK) -> Dict[str, torch.Tensor]:
        g = self.run(node.child)
        vals, idx = top_k(g[node.col], node.k)
        return {node.col: vals, node.index_name: idx}

    def _exchange(self, node: PH.Exchange):
        raise TypeError("Exchange in a single-device physical plan")

    def _compact(self, node: PH.Compact):
        raise TypeError("Compact in a single-device physical plan")

    def _ppartialaggregate(self, node: PH.PPartialAggregate):
        raise TypeError("PPartialAggregate in a single-device plan")

    def _paggregate(self, node: PH.PAggregate) -> Dict[str, torch.Tensor]:
        t = self.run(node.child)
        if node.key is None:
            return self._scalar_aggregate(node, t)
        aggs = dict(node.aggs)
        if node.layout == "xla":
            out = group_aggregate(t, node.key, node.n_groups, aggs,
                                  executor="xla")
        else:
            out = group_aggregate(t, node.key, node.n_groups, aggs,
                                  executor="kernel", layout=node.layout,
                                  mode=self.ctx.mode,
                                  n_partitions=self.ctx.n_partitions,
                                  capacity_factor=self.agg_cf)
        self.overflow = self.overflow + out["_overflow"]
        if self.record:
            self._note(node, groups_occupied=(out["_count"] > 0).sum())
        return out

    def _scalar_aggregate(self, node: PH.PAggregate,
                          t: Table) -> Dict[str, torch.Tensor]:
        w = t.weights()
        cnt = w.sum()[None]
        out: Dict[str, torch.Tensor] = {}
        for name, (op, col) in node.aggs:
            if op == "count":
                out[name] = cnt
                continue
            v = t.col(col).to(torch.float32)
            if op == "sum":
                out[name] = (v * w).sum()[None]
            elif op == "avg":
                out[name] = (v * w).sum()[None] / torch.clamp(cnt, min=1.0)
            elif op == "max":
                out[name] = torch.where(w > 0, v, -torch.inf).max()[None]
            elif op == "min":
                out[name] = torch.where(w > 0, v, torch.inf).min()[None]
            elif op == "median":
                k = torch.where(w > 0, 0, -1)
                out[name] = segment_median(k, v, 1)[0]
            elif op == "distinct":
                k = torch.where(w > 0, 0, -1)
                out[name] = segment_distinct(k, v, 1)[0]
            elif parse_quantile(op) is not None:
                k = torch.where(w > 0, 0, -1)
                out[name] = segment_quantile(k, v, 1, parse_quantile(op))[0]
            else:
                raise ValueError(f"unknown agg op {op!r}")
        out["_count"] = cnt
        out["_overflow"] = torch.zeros((), dtype=torch.int32,
                                       device=w.device)
        return out

    # -- plan root ----------------------------------------------------------
    def execute(self, phys: PH.PhysicalPlan) -> Dict[str, torch.Tensor]:
        if self.record:
            # node id = walk_unique enumerate order: deterministic for a
            # fixed tree, shared with the StatsRegistry's accounting
            self._ids = {n: i
                         for i, n in enumerate(PH.walk_unique(phys.root))}
        res = self.run(phys.root)
        if isinstance(res, Table):
            raise TypeError("plan root must be an Aggregate or TopK node")
        out = dict(res)
        out["_overflow"] = self.overflow
        if phys.outputs is not None:
            out = {k: out[k] for k in phys.outputs}
        if self.record:
            # reserved key, attached after output filtering; every
            # distributed counter is psum'd or computed from replicated
            # tables, so shard 0's are the global ones. CompiledPlan strips
            # it.
            out["_stats"] = self.stats
        return out


class _DistributedExecutor(_LocalExecutor):
    """Placement-policy walker: runs on every shard of a virtual mesh.
    Tables arrive row-sharded (zero-padded, with a ``_valid`` weight
    column folded into each Scan's mask); Exchange nodes execute the
    engine collectives (broadcast all-gathers, hash routes through
    route_table_rows or radix_route_table_rows), Compact nodes re-compact
    routed buffers, and PAggregate's ``merge`` field names the per-policy
    combine. The merged group tables (and so every node after an
    aggregation) are replicated.

    Two Exchange kinds execute FUSED inside their consuming aggregate:
    "gather" (the stacked (keys, vals) matrix is gathered, not the whole
    table) and the partial-sums hash exchange of a pushed-down aggregate
    (pushdown_group_sums routes and merges in one primitive)."""

    def __init__(self, tables, ctx: ExecutionContext, comm: Communicator,
                 profile: Optional[CostProfile] = None,
                 record: bool = False):
        super().__init__(tables, ctx, {}, profile, record)
        self.comm = comm
        self.n = comm.n
        # this shard's parts of GLOBAL counters, summed over the shards in
        # one psum when the walk ends (execute)
        self._parts: Dict[int, Dict[str, torch.Tensor]] = {}

    def _note_parts(self, node: PH.PNode, **parts) -> None:
        """Stash this shard's parts of one node's GLOBAL counters (alive
        rows of its row-sharded slice, rows it sent away, its overflow).
        The reference psums each counter where it is noted; here every
        part of the walk goes into ONE psum at its end, the same
        collective on every shard whether or not its rows are alive (each
        psum of the virtual mesh costs every shard n - 1 device adds and a
        meeting of the shards' threads)."""
        i = self._ids.get(node)
        if i is not None:
            self._parts.setdefault(i, {}).update(parts)

    def execute(self, phys: PH.PhysicalPlan) -> Dict[str, torch.Tensor]:
        out = super().execute(phys)
        if self.record and self._parts:
            names = [(i, k) for i, parts in sorted(self._parts.items())
                     for k in parts]
            total = self.comm.psum(torch.stack(
                [self._parts[i][k].to(torch.int64) for i, k in names]))
            for (i, k), v in zip(names, total.unbind()):
                self.stats.setdefault(i, {})[k] = v
        return out

    def _pscan(self, node: PH.PScan) -> Table:
        cols = {c: a for c, a in self.tables[node.table].items()
                if c != "_valid"}
        return Table(cols, self.tables[node.table]["_valid"])

    def _exchange(self, node: PH.Exchange) -> Table:
        if node.kind in ("gather", "allreduce", "reduce_scatter"):
            raise TypeError(f"{node.kind} Exchange executes fused in "
                            f"PAggregate")
        child = self.run(node.child)
        if node.kind == "broadcast":
            if self.record:
                alive = (child.weights() > 0).sum()
                # every alive row lands on the n-1 shards that did not
                # already hold it (the all-gather's wire traffic)
                self._note_parts(node, alive_in=alive,
                                 moved=alive * (self.n - 1))
            cols = gather_rows(child.columns, self.comm)
            mask = (None if child.mask is None
                    else gather_rows(child.mask, self.comm))
            return Table(cols, mask)
        # hash: all-to-all route the table's rows to their key's owner.
        # Routed padding rows carry weight 0 and key -1, so they never match
        # a real join key; routing overflow goes to the plan's _overflow.
        keys = child.col(node.key).to(torch.int32)
        w0 = child.weights()
        owner = route_owner(keys, w0 > 0, self.n, node.method)
        if node.impl == "radix":
            cols, w, ovf = radix_route_table_rows(
                child.columns, w0, owner, self.n, node.capacity, self.comm,
                mode=self.ctx.mode)
        else:
            cols, w, ovf = route_table_rows(child.columns, w0, owner,
                                            self.n, node.capacity, self.comm)
        self.overflow = self.overflow + self.comm.psum(ovf).to(torch.int32)
        if self.record:
            # "moved" counts ALIVE rows whose owner is another shard: dead
            # padding rows also travel, but the estimate prices payload
            moved = ((w0 > 0) & (owner != self.comm.axis_index())).sum()
            self._note_parts(node, alive_in=(w0 > 0).sum(), moved=moved,
                             alive_out=(w > 0).sum(), overflow=ovf)
        return Table(cols, w)

    def _record_filter(self, node: PH.PFilter, t: Table,
                       out: Table) -> None:
        if self.record:
            self._note_parts(node, alive_in=(t.weights() > 0).sum(),
                             alive_out=(out.weights() > 0).sum())

    def _compact(self, node: PH.Compact) -> Table:
        t = self.run(node.child)
        cols, w, ovf = compact_routed_rows(t.columns, t.weights(),
                                           node.capacity)
        self.overflow = self.overflow + self.comm.psum(ovf).to(torch.int32)
        if self.record:
            self._note_parts(node, alive_in=(t.weights() > 0).sum(),
                             alive_out=(w > 0).sum(), overflow=ovf)
        return Table(cols, w)

    def _record_join(self, node: PH.PJoin, probe: Table, build: Table,
                     joined: Table) -> None:
        if not self.record:
            return
        build_alive = (build.weights() > 0).sum()
        if node.dist == "broadcast":
            # broadcast already gathered the build side: the local count
            # IS the (replicated) global count
            self._note(node, build_alive=build_alive)
        else:
            self._note_parts(node, build_alive=build_alive)
        self._note_parts(node, probe_alive=(probe.weights() > 0).sum(),
                         out_alive=(joined.weights() > 0).sum())

    def _ptopk(self, node: PH.PTopK) -> Dict[str, torch.Tensor]:
        if node.dist != "candidates":
            # "replicated": select on the merged (replicated) group table
            return super()._ptopk(node)
        # candidates: each shard owns a contiguous slot range of the group
        # table (ceil(G/n) slots), selects its local top-k with GLOBAL slot
        # indices, and only the k candidate pairs per shard converge. Equal
        # bits to "replicated": within a shard top_k breaks ties by lowest
        # index, the rank-order all_gather keeps ascending global index
        # among equal values across shards, and the final top_k over the
        # k*n candidates breaks ties by candidate position.
        ex = node.child
        g = self.run(ex.child)
        vals = g[node.col]
        G = vals.shape[0]
        slots = (G + (-G % self.n)) // self.n
        owned = (torch.arange(G, device=vals.device) // slots
                 ) == self.comm.axis_index()
        local_vals, local_idx = top_k(torch.where(owned, vals, -torch.inf),
                                      node.k)
        cand_vals = self.comm.all_gather(local_vals)
        cand_idx = self.comm.all_gather(local_idx)
        if self.record:
            # the gather's wire volume: k candidate rows per shard, each
            # landing on the n-1 shards that did not produce it
            self._note(ex, alive_in=node.k * self.n,
                       moved=node.k * (self.n - 1) * self.n)
        top_vals, pos = top_k(cand_vals, node.k)
        return {node.col: top_vals, node.index_name: cand_idx[pos.long()]}

    def _ppartialaggregate(self, node: PH.PPartialAggregate):
        """Local (n_groups, C) stacked partial sums: the below-the-exchange
        half of push-down and of the FT/LA partial-table merges."""
        t = self.run(node.child)
        keys, vals, _src = stacked_columns(t, node.key, node.n_groups,
                                           dict(node.aggs))
        return self._stacked(keys, vals, node.n_groups, node.layout)

    def _table_source(self, node: PH.PNode) -> PH.PNode:
        """The table-producing node under an aggregate's movement/partial
        wrappers: order statistics must see the records exactly once,
        before any exchange."""
        while isinstance(node, (PH.Exchange, PH.PPartialAggregate)):
            node = node.child
        return node

    def _paggregate(self, node: PH.PAggregate) -> Dict[str, torch.Tensor]:
        if node.key is None:
            return self._dist_scalar_aggregate(node, self.run(node.child))
        t = self.run(self._table_source(node.child))
        G = node.n_groups
        dist_aggs = tuple((nm, oc) for nm, oc in node.aggs
                          if not is_holistic(oc[0]))
        med_out, med_counts, med_ovf = self._dist_medians(node, t, G)
        if not dist_aggs:
            # holistic-only: counts come from the selection path
            out = dict(med_out)
            out["_count"] = med_counts
            out["_overflow"] = med_ovf
            self.overflow = self.overflow + med_ovf
            if self.record:
                self._note(node, groups_occupied=(out["_count"] > 0).sum())
            return out
        sums, overflow = self._merged_sums(node, t, G, dist_aggs)
        out = finalize_stacked(dict(dist_aggs), _stacked_src(dist_aggs),
                               sums, self._order_stat_fn(t, node, G))
        out.update(med_out)
        out["_overflow"] = overflow.to(torch.int32) + med_ovf
        self.overflow = self.overflow + out["_overflow"]
        if self.record:
            self._note(node, groups_occupied=(out["_count"] > 0).sum())
        return out

    def _merged_sums(self, node: PH.PAggregate, t: Table, G: int,
                     dist_aggs) -> Tuple[torch.Tensor, torch.Tensor]:
        """The distributive stacked-sums table under ``node.merge``."""
        comm, n = self.comm, self.n
        merge = node.merge
        if merge in ("psum", "reduce_scatter"):
            # the child is the fused allreduce/reduce_scatter Exchange; the
            # partial table comes from BELOW it
            partial, ovf = self.run(node.child.child)
            policy = (PlacementPolicy.FIRST_TOUCH if merge == "psum"
                      else PlacementPolicy.LOCAL_ALLOC)
            return (merge_partial_table(partial, policy, comm, n),
                    comm.psum(ovf))
        if merge == "pushdown":
            partial, ovf = self.run(node.child.child)
            sums, route_ovf = pushdown_group_sums(
                partial, G, comm, n,
                capacity_factor=self.ctx.capacity_factor,
                capacity=node.child.capacity)
            return sums, comm.psum(ovf) + route_ovf
        if merge == "placed":
            # route-once: every group's rows are co-located, so the
            # per-shard tables are DISJOINT and the psum is exact
            keys, vals, _ = stacked_columns(t, node.key, G, dict(dist_aggs))
            sums, ovf = self._stacked(keys, vals, G, node.layout)
            return comm.psum(sums), comm.psum(ovf)
        if merge == "owner":
            keys, vals, _ = stacked_columns(t, node.key, G, dict(dist_aggs))
            agg_fn = functools.partial(self._stacked, layout=node.layout)
            # the Exchange node's capacity drives the routing: execution
            # cannot drift from the rendered physical plan
            return interleave_group_sums(
                keys, vals, G, comm, n, agg_fn,
                capacity_factor=self.ctx.capacity_factor,
                capacity=node.child.capacity)
        if merge == "gather":
            keys, vals, _ = stacked_columns(t, node.key, G, dict(dist_aggs))
            ak, av = gather_rows((keys, vals), comm)
            return self._stacked(ak, av, G, node.layout)
        raise ValueError(f"unknown aggregate merge {merge!r}")

    def _stacked(self, keys, vals, n_groups, layout):
        return stacked_group_sums(
            keys, vals, n_groups, layout=layout, mode=self.ctx.mode,
            n_partitions=self.ctx.n_partitions, capacity_factor=self.agg_cf)

    def _order_stat_fn(self, t: Table, node: PH.PAggregate, G: int):
        keys = torch.clamp(t.col(node.key), 0, G - 1).to(torch.int32)

        def order_stat(op, col):
            # local segment op, then a cross-shard reduction
            local = segment_order_stat(t, keys, G, op, col)
            return (self.comm.pmax(local) if op == "max"
                    else self.comm.pmin(local))

        return order_stat

    def _dist_medians(self, node: PH.PAggregate, t: Table, G: int):
        """Per-policy lowering of an Aggregate's holistic aggs: "replicate"
        gathers the records, "route" sends each group's records to its
        owner and selects there, "placed" selects on the shard that
        already holds the group. Returns ({name: (G,) stats},
        counts-or-None, overflow), all replicated in natural group
        order."""
        comm, n = self.comm, self.n
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        med_aggs = tuple((nm, oc) for nm, oc in node.aggs
                         if is_holistic(oc[0]))
        if not med_aggs:
            return {}, None, zero
        keys = torch.clamp(t.col(node.key), 0, G - 1).to(torch.int32)
        w = t.weights()
        cols = {name: t.col(colname).to(torch.float32)
                for name, (_op, colname) in med_aggs}
        ranks = {name: holistic_selector(op)
                 for name, (op, _c) in med_aggs}          # None = median
        if node.med_strategy == "route":
            meds, counts, ovf = interleave_group_median(
                keys, cols, w, G, comm, n,
                capacity_factor=self.ctx.capacity_factor, ranks=ranks)
            return meds, counts, ovf.to(torch.int32)
        if node.med_strategy == "placed":
            meds, counts = placed_group_median(keys, cols, w, G, comm,
                                               ranks=ranks)
            return meds, counts, zero
        meds, counts = replicated_group_median(keys, cols, w, G, comm,
                                               ranks=ranks)
        return meds, counts, zero

    def _dist_scalar_aggregate(self, node: PH.PAggregate,
                               t: Table) -> Dict[str, torch.Tensor]:
        """Global aggregate: merge the SUMS across shards (an average of
        per-shard averages would weight shards, not rows)."""
        comm = self.comm
        w = t.weights()
        cnt = comm.psum(w.sum())[None]
        out: Dict[str, torch.Tensor] = {}
        med_cols: Dict[str, torch.Tensor] = {}
        med_ranks: Dict[str, object] = {}
        for name, (op, col) in node.aggs:
            if op == "count":
                out[name] = cnt
                continue
            v = t.col(col).to(torch.float32)
            if op in ("sum", "avg"):
                s = comm.psum((v * w).sum())[None]
                out[name] = (s if op == "sum"
                             else s / torch.clamp(cnt, min=1.0))
            elif op == "max":
                out[name] = comm.pmax(
                    torch.where(w > 0, v, -torch.inf).max())[None]
            elif op == "min":
                out[name] = comm.pmin(
                    torch.where(w > 0, v, torch.inf).min())[None]
            elif is_holistic(op):
                med_cols[name] = v       # batched below: gather rows once
                med_ranks[name] = holistic_selector(op)
            else:
                raise ValueError(f"unknown agg op {op!r}")
        if med_cols:
            meds, _ = replicated_group_median(
                torch.zeros_like(w, dtype=torch.int32), med_cols, w, 1,
                comm, ranks=med_ranks)
            out.update(meds)
        out["_count"] = cnt
        out["_overflow"] = torch.zeros((), dtype=torch.int32,
                                       device=w.device)
        return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _device_of(tables) -> Optional[torch.device]:
    for cols in tables.values():
        for a in cols.values():
            return a.device if isinstance(a, torch.Tensor) else None
    return None


def _signature(tables) -> Tuple:
    return tuple(sorted((t, c, tuple(a.shape), str(a.dtype),
                         str(getattr(a, "device", "cpu")))
                        for t, cols in tables.items()
                        for c, a in cols.items()))


def table_signature(tables) -> Tuple:
    """Shape signature of a {table: {column: tensor}} mapping: the axis of
    the plan-cache key that identifies structurally identical data (the
    device is part of it, so CPU and CUDA tables keep separate entries)."""
    return _signature(tables)


def cached_executable(key: Tuple, build):
    """Fetch-or-build a callable in the shared bounded plan LRU.

    The seam for auxiliary callables that must live under the same cache
    bound and thread-safety as compiled plans (the serving scheduler's
    per-morsel functions). ``key`` starts with a distinguishing tag so it
    never collides with compile_plan's keys."""
    fn = _PLAN_CACHE.get(key)
    if fn is None:
        fn = build()
        _PLAN_CACHE.put(key, fn)
    return fn


def _true_rows(tables) -> Dict[str, int]:
    return {t: next(iter(cols.values())).shape[0]
            for t, cols in tables.items()}


def _run_distributed(phys: PH.PhysicalPlan, ctx: ExecutionContext, profile,
                     record, tables):
    """Run ``phys`` on a virtual mesh of ``ctx.n_shards`` shards on the
    tables' device. Each table is zero-padded to a multiple of n rows and
    gets a ``_valid`` weight column; shard i takes the i-th contiguous
    block of rows (``shard_map``'s ``P(axis)``). The outputs are
    replicated, so shard 0's are returned."""
    n = ctx.n_shards
    rows = _true_rows(tables)
    padded = {}
    for t, cols in tables.items():
        r = rows[t]
        pad = -r % n
        pcols = {c: torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                 if pad else a for c, a in cols.items()}
        dev = next(iter(cols.values())).device
        pcols["_valid"] = (torch.arange(r + pad, device=dev) < r
                           ).to(torch.float32)
        padded[t] = pcols

    def local_fn(comm, local_tables):
        return _DistributedExecutor(local_tables, ctx, comm, profile,
                                    record).execute(phys)

    mesh = VirtualMesh(n, _device_of(tables))
    return mesh.run(local_fn, shard_rows(padded, n))[0]


def _run_plan(phys: PH.PhysicalPlan, ctx: ExecutionContext, profile,
              record, tables, indexes):
    if ctx.n_shards is not None:
        # full-table join indexes do not survive the row padding
        return _run_distributed(phys, ctx, profile, record, tables)
    return _LocalExecutor(tables, ctx, indexes, profile,
                          record).execute(phys)


def _read_stats(stats) -> Dict[int, Dict[str, int]]:
    """The walk's noted counters as Python ints: every device scalar read
    back in ONE transfer (one host sync), however many nodes noted."""
    flat = [(i, k, v) for i, vals in stats.items() for k, v in vals.items()]
    dev = [v for _i, _k, v in flat if isinstance(v, torch.Tensor)]
    read = iter(torch.stack([v.reshape(()).to(torch.int64) for v in dev])
                .tolist() if dev else ())
    out: Dict[int, Dict[str, int]] = {}
    for i, k, v in flat:
        out.setdefault(int(i), {})[k] = (next(read)
                                         if isinstance(v, torch.Tensor)
                                         else int(v))
    return out


class CompiledPlan:
    """Re-entrant dispatch handle for one (plan, context, shape signature).

    ``compile_plan`` resolves the plan-cache entry once; each call only
    consults the join-index pool (a lock-protected LRU hit). ``physical``
    is the physical plan the callable walks.

    Compiled under telemetry (``record``), each call strips the reserved
    ``"_stats"`` output, reads it back (one host sync, the price of
    observing) and folds it into the StatsRegistry under ``cache_key``
    with the dispatch's wall time. Under tracing, each call is a
    ``plan.execute`` span, and the operator, sync and kernel spans of its
    walk nest under it. Its clock is the host's and the launches are
    asynchronous, so an untracked span covers the host's issue of the
    plan's work, not its completion on the device (a tracked one ends
    after the stats' read-back); the sync spans under it show where that
    work is waited for. Tracing adds no sync."""

    __slots__ = ("plan", "ctx", "fn", "index_specs", "physical", "cache_key",
                 "record")

    def __init__(self, plan: L.LogicalPlan, ctx: ExecutionContext, fn,
                 index_specs: Tuple[Tuple[str, str], ...],
                 physical: PH.PhysicalPlan, cache_key: Tuple = (),
                 record: bool = False):
        self.plan = plan
        self.ctx = ctx
        self.fn = fn
        self.index_specs = index_specs
        self.physical = physical
        self.cache_key = cache_key
        self.record = record

    def __call__(self, tables) -> Dict[str, torch.Tensor]:
        # the tracing flag is read HERE, per dispatch, and is not part of
        # the plan-cache key: plan.execute is a host-side span around an
        # unchanged callable
        if not tracing.tracing_enabled():
            return self._execute(tables)
        with tracing.span("plan.execute", "plan", pid="plan",
                          key=hash(self.cache_key), recorded=self.record):
            return self._execute(tables)

    def _execute(self, tables) -> Dict[str, torch.Tensor]:
        indexes = {}
        if self.ctx.n_shards is None:
            for t, c in self.index_specs:
                indexes[f"{t}.{c}"] = _INDEX_POOL.get(t, c, tables[t][c])
        if not self.record:
            return self.fn(tables, indexes)
        t0 = time.perf_counter()
        out = dict(self.fn(tables, indexes))
        stats = out.pop("_stats", None)
        if stats is not None:
            telemetry.registry().record(self.cache_key, self.physical,
                                        _read_stats(stats),
                                        time.perf_counter() - t0)
        return out


def compile_plan(plan: L.LogicalPlan, tables,
                 ctx: Optional[ExecutionContext] = None) -> CompiledPlan:
    """Lower to a physical plan and resolve (or build) its callable.

    ``tables`` supplies only the shape signature and device. The active
    CostProfile is snapshotted ONCE: it keys the cache AND parameterizes
    the lowering. The cache value is the (physical plan, callable) pair.
    The telemetry flag keys the cache (a recording walk returns extra
    outputs, so it is never served to an untracked caller); the tracing
    flag does not."""
    ctx = ctx or ExecutionContext()
    profile = current_cost_profile()
    record = telemetry.telemetry_enabled()
    key = (plan, ctx.cache_key(), _signature(tables), profile, record)
    entry = _PLAN_CACHE.get(key)
    if entry is None:
        # the lowering a cache hit amortizes away
        with tracing.span("plan.compile", "plan", pid="plan", key=hash(key)):
            L.validate(plan)     # fail fast (and once)
            phys = lower(plan, ctx, _true_rows(tables), profile)
            entry = (phys, functools.partial(_run_plan, phys, ctx, profile,
                                             record))
            _PLAN_CACHE.put(key, entry)
    elif record:
        entry = _maybe_replan(key, entry, plan, ctx, profile, tables)
    phys, fn = entry
    return CompiledPlan(plan, ctx, fn, required_indexes(plan.root), phys, key,
                        record)


def _maybe_replan(key, entry, plan, ctx, profile, tables):
    """Adaptive re-planning on a plan-cache HIT: when the registry marked
    this plan as drifting, re-lower with the OBSERVED per-join alive rows
    and swap the cache entry if any decision flipped. Results stay
    bit-identical (the observed hook only steers the broadcast-vs-
    partitioned cost choice), and a re-lowering whose decisions all stand
    gives a structurally identical tree, so the existing entry stays."""
    reg = telemetry.registry()
    if not reg.should_replan(key):
        return entry
    reg.note_replan_checked(key)
    phys = lower(plan, ctx, _true_rows(tables), profile,
                 observed=reg.observed_joins(key))
    if phys == entry[0]:
        return entry
    entry = (phys, functools.partial(_run_plan, phys, ctx, profile, True))
    _PLAN_CACHE.put(key, entry)
    reg.note_replanned(key, phys)
    return entry


def execute_plan(plan: L.LogicalPlan, tables,
                 ctx: Optional[ExecutionContext] = None
                 ) -> Dict[str, torch.Tensor]:
    """Compile (through the LRU plan cache) and run a logical plan on a
    {table: {column: tensor}} mapping."""
    return compile_plan(plan, tables, ctx)(tables)


# ---------------------------------------------------------------------------
# explain: decisions + physical-tree rendering
# ---------------------------------------------------------------------------
def _strip_movement(node: PH.PNode) -> PH.PNode:
    """The record-producing node under movement/partial wrappers."""
    while isinstance(node, (PH.Exchange, PH.Compact,
                            PH.PPartialAggregate)):
        node = node.child
    return node


def explain(plan: L.LogicalPlan, tables,
            ctx: Optional[ExecutionContext] = None) -> List[Decision]:
    """The planner's choices from shape metadata alone (no execution):
    one Decision per Join / grouped Aggregate — plus, since the physical
    layer, per Exchange (kind + estimated moved rows) and per Compact —
    in plan order. Decisions are derived from the SAME lower() pass that
    produces the executed physical plan, so explain can never drift from
    execution."""
    ctx = ctx or ExecutionContext()
    phys = lower(plan, ctx, _true_rows(tables))
    n = phys.n_shards
    decisions: List[Decision] = []
    seen = set()

    def visit(node: PH.PNode) -> None:
        if node in seen:         # structural dedup == executor memoization
            return
        seen.add(node)
        for c in PH.children(node):
            visit(c)
        if isinstance(node, PH.PJoin):
            probe = _strip_movement(node.probe)
            build = _strip_movement(node.build)
            if node.dist is not None:
                decisions.append(Decision(
                    "DistJoin", f"{node.probe_key}={node.build_key}, "
                    f"probe={probe.rows * n}, build={build.rows * n}, "
                    f"shards={n}", node.dist,
                    tuple(dist_join_costs(probe.rows * n, build.rows * n,
                                          n).items())))
            else:
                decisions.append(Decision(
                    "Join", f"{node.probe_key}={node.build_key}, "
                    f"probe={probe.rows}, build={build.rows}",
                    node.strategy))
        elif isinstance(node, PH.Exchange):
            # key=None marks a partial-sums routing ONLY for hash
            # exchanges; broadcast/gather move whole tables and carry no
            # routing key at all
            if node.key is not None:
                detail = f"kind={node.kind}, key={node.key}"
                # key-routing hash exchange: the layout-pass impl is a
                # planner choice, priced alongside the wire estimate
                # (moved_rows stays FIRST — consumers index costs[0])
                costs = ((("moved_rows", float(node.moved_rows)),)
                         + tuple(exchange_costs(node.child.rows).items()))
                decisions.append(Decision(
                    "Exchange", f"{detail}, rows={node.rows}",
                    f"{node.kind}/{node.impl}", costs))
                return
            if node.kind == "hash":
                detail = f"kind={node.kind}, key=<group-partials>"
            else:
                detail = f"kind={node.kind}"
            decisions.append(Decision(
                "Exchange", f"{detail}, rows={node.rows}", node.kind,
                (("moved_rows", float(node.moved_rows)),)))
        elif isinstance(node, PH.PFilter) and node.pushed:
            decisions.append(Decision(
                "FilterBelowExchange", L.expr_str(node.pred),
                "pushed"))
        elif isinstance(node, PH.PTopK) and node.dist is not None:
            G = _strip_movement(node.child).rows
            decisions.append(Decision(
                "DistTopK", f"col={node.col}, k={node.k}, groups={G}, "
                f"shards={n}", node.dist,
                tuple(topk_costs(G, node.k, n).items())))
        elif isinstance(node, PH.Compact):
            decisions.append(Decision(
                "Compact", f"capacity={node.capacity}, "
                f"from={node.child.rows}", "compact",
                (("rows_cut", float(node.child.rows - node.capacity)),)))
        elif isinstance(node, PH.PAggregate) and node.key is not None:
            N = _strip_movement(node.child).rows
            C = stacked_width(node.aggs)
            G = node.n_groups
            # cost basis = the inputs the layout was actually CHOSEN from
            # (lower's per-merge arithmetic), so the printed table can
            # justify the printed choice: owner-merge aggregates run on
            # the routed buffer over per-shard slots, gather-merge on the
            # converged rows, everything else on the record input
            if node.merge == "owner" and isinstance(node.child, PH.Exchange):
                cost_n = node.child.rows
                cost_g = (G + (-G % n)) // n + 1
            elif node.merge == "gather":
                cost_n, cost_g = N * n, G
            else:
                cost_n, cost_g = N, G
            detail = f"key={node.key}, rows={N}, groups={G}, cols={C}"
            if node.merge is not None:
                detail += f", merge={node.merge}"
            decisions.append(Decision(
                "Aggregate", detail, node.layout,
                tuple(aggregate_costs(cost_n, cost_g, C).items())))

    visit(phys.root)
    return decisions


def explain_physical(plan: L.LogicalPlan, tables,
                     ctx: Optional[ExecutionContext] = None,
                     n_shards: Optional[int] = None) -> str:
    """Render the lowered physical tree (physical.describe): Exchange
    kinds with estimated moved rows, compaction points, resolved join/
    aggregate strategies. Deterministic for fixed table shapes — the
    golden-snapshot format. ``n_shards`` lowers for a mesh width without
    materializing devices."""
    ctx = ctx or ExecutionContext()
    return PH.describe(lower(plan, ctx, _true_rows(tables),
                             n_shards=n_shards))


# explain_analyze (execute under telemetry, annotate the tree with observed
# rows) lives in telemetry.py; re-exported here beside explain_physical.
explain_analyze = telemetry.explain_analyze
