"""Execution telemetry: the port of ``repro.analytics.telemetry``.
Observed Exchange/Compact/Join stats fed back into the cost model.

The planner prices every data movement statically (``Exchange.est`` /
``moved_rows``, Compact margins, ``dist_route_factor``) from table shapes
alone: filter selectivity, key skew and padding occupancy are invisible
to it. This module closes the loop:

  1. **Recording.** With telemetry enabled (``enable_telemetry()`` or the
     ``recording()`` context manager), both executors note per-node
     observed stats (alive rows into and out of every Exchange and
     Compact, rows that crossed shards, routing overflow, join input and
     output alive rows, occupied groups per aggregate) as device tensors,
     returned under the reserved key ``"_stats"``. The dispatch handle
     (``planner.CompiledPlan``) reads them back in ONE transfer after each
     call and folds them into the bounded, thread-safe ``StatsRegistry``,
     keyed by plan-cache key + physical node id. Disabled (the default),
     the walk makes no extra launch and no host sync: every recording site
     sits behind ``if self.record``, and the flag is part of the
     plan-cache key.

  2. **Drift detection.** Each recorded execution compares observed
     alive/moved rows with the node's static estimate; entries outside
     ``DRIFT_BAND`` (or any overflow) mark the plan as drifting.
     ``drift_report()`` lists every drifting node; ``refresh_profile()``
     rewrites the drifting ``CostProfile`` entries
     (``dist_route_factor``, ``filter_selectivity``, ``compact_margin``).

  3. **Re-planning.** On a plan-cache HIT of a drifting plan,
     ``planner.compile_plan`` re-lowers with the OBSERVED per-join alive
     rows in place of the static estimates. If the cost model then flips
     a decision (e.g. broadcast -> partitioned once the probe filter's
     true selectivity is known), the cache entry is replaced; results
     stay bit-identical because only the lowering changes.

``explain_analyze(plan, tables, ctx)`` runs a plan under telemetry and
renders the physical tree with estimated-vs-observed rows per node.

Wall time is recorded per plan (per dispatch): per-operator wall time on
a card would need a sync per operator, so the per-node row counters are
the per-operator signal and the wall histogram the per-plan one.

Standard library + the physical IR only; the planner imports this
module, never the reverse (``refresh_profile`` and ``explain_analyze``
import the planner when called).
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analytics import physical as PH

# observed/estimated ratio outside [1/DRIFT_BAND, DRIFT_BAND] = drift
DRIFT_BAND = 1.25
# refresh clamps: one execution's ratio can rescale a constant by at most
# this factor in either direction (a single pathological batch cannot
# swing the profile to an extreme)
_REFRESH_CLAMP = 4.0


# ---------------------------------------------------------------------------
# enable flag
# ---------------------------------------------------------------------------
_ENABLED = False
_ENABLE_LOCK = threading.Lock()


def telemetry_enabled() -> bool:
    return _ENABLED


def enable_telemetry() -> None:
    global _ENABLED
    with _ENABLE_LOCK:
        _ENABLED = True


def disable_telemetry() -> None:
    global _ENABLED
    with _ENABLE_LOCK:
        _ENABLED = False


@contextmanager
def recording():
    """Enable recording for the duration of a block (not reference
    counted: nested blocks share the one global flag)."""
    prev = _ENABLED
    enable_telemetry()
    try:
        yield registry()
    finally:
        if not prev:
            disable_telemetry()


# ---------------------------------------------------------------------------
# per-node observed stats
# ---------------------------------------------------------------------------
@dataclass
class NodeStats:
    """Observed counters for one physical node of one cached plan.

    ``est`` maps stat name -> the static estimate it is compared against
    (GLOBAL rows — per-shard node fields are scaled by n_shards at
    registration). ``last`` holds the most recent execution's observed
    values, ``total`` their sum over executions (the conservation tests
    check ``last`` exactly; drift uses ``last`` so a corrected upstream
    decision clears stale drift immediately)."""
    kind: str                      # "exchange" | "compact" | "join" | ...
    detail: str                    # one-line node description
    est: Dict[str, int] = field(default_factory=dict)
    last: Dict[str, int] = field(default_factory=dict)
    total: Dict[str, int] = field(default_factory=dict)
    executions: int = 0

    def observe(self, vals: Dict[str, int]) -> None:
        self.executions += 1
        for k, v in vals.items():
            self.last[k] = int(v)
            self.total[k] = self.total.get(k, 0) + int(v)

    def drifts(self) -> List[Tuple[str, int, int, float]]:
        """(stat, est, observed, ratio) for every stat outside the band
        (overflow drifts whenever it is nonzero — an estimate that let a
        buffer overflow is mis-priced by definition)."""
        out = []
        if self.last.get("overflow", 0) > 0:
            out.append(("overflow", 0, self.last["overflow"], math.inf))
        for stat, est in self.est.items():
            obs = self.last.get(stat)
            if obs is None:
                continue
            ratio = (obs / est) if est > 0 else (math.inf if obs else 1.0)
            if not (1.0 / DRIFT_BAND) <= ratio <= DRIFT_BAND:
                out.append((stat, est, obs, ratio))
        return out


@dataclass
class PlanStats:
    """Registry value for one plan-cache key."""
    phys: PH.PhysicalPlan
    nodes: Dict[int, NodeStats] = field(default_factory=dict)
    executions: int = 0
    replans: int = 0
    pending_replan: bool = False
    wall_s: deque = field(default_factory=lambda: deque(maxlen=256))

    def node_list(self) -> List[PH.PNode]:
        return list(PH.walk_unique(self.phys.root))


def _node_estimates(node: PH.PNode, n: int) -> Tuple[str, Dict[str, int]]:
    """(kind, {stat: GLOBAL estimated rows}) for one physical node.

    Scaling per node kind mirrors the lowering's bookkeeping: hash
    Exchange / Compact ``est`` is per-shard alive rows; broadcast and
    gather Exchange ``est`` is already global (the whole gathered
    table)."""
    if isinstance(node, PH.Exchange):
        if node.kind == "hash":
            return "exchange", {"alive_in": node.est * n,
                                "moved": node.moved_rows * n}
        # broadcast/gather: est and moved_rows are global already
        return "exchange", {"alive_in": node.est,
                            "moved": node.moved_rows * n}
    if isinstance(node, PH.Compact):
        return "compact", {"alive_in": node.est * n}
    if isinstance(node, PH.PJoin) and node.dist is not None:
        probe = node.probe
        while isinstance(probe, (PH.Exchange, PH.Compact)):
            probe = probe.child
        build = node.build
        while isinstance(build, (PH.Exchange, PH.Compact)):
            build = build.child
        return "join", {"probe_alive": probe.est * n,
                        "build_alive": build.est * n}
    if isinstance(node, PH.PJoin):
        return "join", {}
    if isinstance(node, PH.PAggregate) and node.key is not None:
        return "aggregate", {"groups_occupied": node.n_groups}
    return type(node).__name__.lower(), {}


def _node_detail(node: PH.PNode) -> str:
    return PH.describe(node).splitlines()[0].strip()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
class StatsRegistry:
    """Bounded, thread-safe store of per-plan execution telemetry.

    Keys are plan-cache keys (hashable tuples); values PlanStats. LRU
    bounded so an always-on service with churning ad-hoc plans cannot
    grow it without bound."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._plans: "OrderedDict[tuple, PlanStats]" = OrderedDict()
        self.replans = 0           # decision flips across all plans

    # -- recording ----------------------------------------------------------
    def record(self, key, phys: PH.PhysicalPlan,
               node_stats: Dict[int, Dict[str, int]],
               wall_s: float) -> None:
        """Fold one execution's observed stats in. ``node_stats`` maps
        node id (enumerate order of walk_unique over ``phys.root``) to
        {stat: observed int}."""
        n = max(phys.n_shards, 1)
        with self._lock:
            ps = self._plans.get(key)
            if ps is None or ps.phys != phys:
                # new plan, or a replan replaced the tree: node ids no
                # longer line up, start a fresh accumulator
                ps = PlanStats(phys)
                self._plans[key] = ps
            self._plans.move_to_end(key)
            while len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
            nodes = ps.node_list()
            ps.executions += 1
            ps.wall_s.append(float(wall_s))
            drifting = False
            for i, vals in node_stats.items():
                node = nodes[i]
                ns = ps.nodes.get(i)
                if ns is None:
                    kind, est = _node_estimates(node, n)
                    ns = NodeStats(kind, _node_detail(node), est)
                    ps.nodes[i] = ns
                ns.observe(vals)
                if ns.drifts():
                    drifting = True
            if drifting:
                ps.pending_replan = True

    # -- lookups ------------------------------------------------------------
    def get(self, key) -> Optional[PlanStats]:
        with self._lock:
            return self._plans.get(key)

    def plans(self) -> List[Tuple[tuple, PlanStats]]:
        with self._lock:
            return list(self._plans.items())

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.replans = 0

    # -- re-planning protocol ----------------------------------------------
    def should_replan(self, key) -> bool:
        ps = self.get(key)
        return ps is not None and ps.pending_replan

    def note_replan_checked(self, key) -> None:
        ps = self.get(key)
        if ps is not None:
            ps.pending_replan = False

    def note_replanned(self, key, new_phys: PH.PhysicalPlan) -> None:
        with self._lock:
            ps = self._plans.get(key)
            self.replans += 1
            if ps is not None:
                # keep the execution/replan history, reset node stats to
                # the new tree (ids refer to the new walk order)
                fresh = PlanStats(new_phys)
                fresh.executions = ps.executions
                fresh.replans = ps.replans + 1
                fresh.wall_s = ps.wall_s
                self._plans[key] = fresh

    def observed_joins(self, key) -> Callable:
        """An ``observed(probe_key, build_key)`` lookup for re-lowering:
        the most recent OBSERVED global alive rows of each distributed
        join's inputs, consumed FIFO per key pair (re-lowering descends
        the same logical tree in the same order, so repeated joins over
        the same column pair line up; a plan pathological enough to break
        that alignment just re-derives the static choice)."""
        ps = self.get(key)
        fifo: Dict[Tuple[str, str], deque] = {}
        if ps is not None:
            nodes = ps.node_list()
            for i, ns in sorted(ps.nodes.items()):
                node = nodes[i]
                if (isinstance(node, PH.PJoin) and node.dist is not None
                        and "probe_alive" in ns.last):
                    fifo.setdefault(
                        (node.probe_key, node.build_key), deque()).append(
                            (ns.last["probe_alive"],
                             ns.last["build_alive"]))

        def observed(probe_key: str, build_key: str):
            q = fifo.get((probe_key, build_key))
            return q.popleft() if q else None

        return observed

    # -- reporting ----------------------------------------------------------
    def drift_report(self) -> List[Dict]:
        """Every drifting (plan, node, stat) triple, worst ratio first."""
        rows: List[Dict] = []
        for _key, ps in self.plans():
            for i, ns in ps.nodes.items():
                for stat, est, obs, ratio in ns.drifts():
                    rows.append({
                        "node": ns.detail, "kind": ns.kind, "stat": stat,
                        "estimated": est, "observed": obs,
                        "ratio": None if math.isinf(ratio) else
                        round(ratio, 4),
                        "executions": ns.executions,
                    })
        def sort_key(r):
            if r["ratio"] is None:
                return math.inf
            return max(r["ratio"], 1.0 / max(r["ratio"], 1e-9))
        rows.sort(key=sort_key, reverse=True)
        return rows

    def drift_summary(self) -> Dict[str, float]:
        """Max |observed/estimated| deviation ratio per Decision kind
        (>= 1.0; 1.0 = estimates exact). The benchmark-JSON drift rows."""
        worst: Dict[str, float] = {}
        for _key, ps in self.plans():
            for ns in ps.nodes.values():
                for stat, est in ns.est.items():
                    obs = ns.last.get(stat)
                    if obs is None:
                        continue
                    if est > 0:
                        r = obs / est
                        dev = max(r, 1.0 / r) if r > 0 else DRIFT_BAND * 2
                    else:
                        dev = DRIFT_BAND * 2 if obs else 1.0
                    worst[ns.kind] = max(worst.get(ns.kind, 1.0), dev)
        return worst

    def summary(self) -> Dict[str, int]:
        plans = self.plans()
        return {
            "plans_tracked": len(plans),
            "executions": sum(ps.executions for _k, ps in plans),
            "drifting_plans": sum(
                1 for _k, ps in plans
                if any(ns.drifts() for ns in ps.nodes.values())),
            "replans": self.replans,
        }


_REGISTRY = StatsRegistry()


def registry() -> StatsRegistry:
    return _REGISTRY


# ---------------------------------------------------------------------------
# profile refresh (drift -> corrected CostProfile entries)
# ---------------------------------------------------------------------------
def refresh_profile(profile=None, reg: Optional[StatsRegistry] = None):
    """A CostProfile with drifting entries rewritten from observed stats.

    * ``dist_route_factor`` — scaled by the worst observed/estimated
      moved-rows ratio over key-routing hash Exchanges: the static
      estimate prices every input row as movable, so a selective filter
      under a partitioned join shows up here as obs << est and the
      factor shrinks toward the traffic actually paid (and vice versa
      for overflowing/skewed routings).
    * ``compact_margin`` — sized so the worst observed Compact occupancy
      fits with DRIFT_BAND headroom; any Compact overflow grows it.
    * ``filter_selectivity`` — replaced by the observed alive_out/alive_in
      ratio of the PFilter whose log deviates most from the prior: the
      constant the Filter-below-Exchange rewrite discounts Exchange
      ``moved_rows`` by, so the wire estimate tracks what selective
      predicates actually let through.
    * ``dense_group_limit`` — NEVER auto-refreshed (a model of the
      kernel's table width, not a row estimate); occupancy drift on dense
      aggregates is visible in ``drift_report()`` instead.

    Returns the refreshed profile (``source="telemetry"``); install with
    ``planner.set_cost_profile``. Without any relevant drift the input
    profile is returned unchanged."""
    import dataclasses

    from repro_torch.analytics import planner

    reg = reg or _REGISTRY
    profile = profile or planner.current_cost_profile()
    route_ratio: Optional[float] = None
    margin_need: Optional[float] = None
    sel_obs: Optional[float] = None
    prior_sel = max(profile.filter_selectivity, 1e-9)
    for _key, ps in reg.plans():
        n = max(ps.phys.n_shards, 1)
        nodes = ps.node_list()
        for i, ns in ps.nodes.items():
            node = nodes[i]
            if (isinstance(node, PH.Exchange) and node.kind == "hash"
                    and node.key is not None and "moved" in ns.last):
                est = max(ns.est.get("moved", 0), 1)
                r = ns.last["moved"] / est
                if route_ratio is None or abs(math.log(max(r, 1e-9))) > \
                        abs(math.log(max(route_ratio, 1e-9))):
                    route_ratio = r
            if (isinstance(node, PH.PFilter)
                    and ns.last.get("alive_in", 0) > 0):
                sel = ns.last.get("alive_out", 0) / ns.last["alive_in"]
                r = max(sel, 1e-9) / prior_sel
                if sel_obs is None or abs(math.log(r)) > abs(math.log(
                        max(sel_obs, 1e-9) / prior_sel)):
                    sel_obs = sel
            if isinstance(node, PH.Compact) and "alive_in" in ns.last:
                est = max(ns.est.get("alive_in", 0), 1)
                occ = ns.last["alive_in"] / est
                if ns.last.get("overflow", 0) > 0:
                    occ = max(occ, 1.0) * DRIFT_BAND
                need = occ * DRIFT_BAND
                margin_need = max(margin_need or 0.0, need)
    updates = {}
    if route_ratio is not None and not \
            (1.0 / DRIFT_BAND) <= route_ratio <= DRIFT_BAND:
        scale = min(max(route_ratio, 1.0 / _REFRESH_CLAMP), _REFRESH_CLAMP)
        updates["dist_route_factor"] = round(
            max(profile.dist_route_factor * scale, 0.01), 4)
    if sel_obs is not None and not \
            (1.0 / DRIFT_BAND) <= sel_obs / prior_sel <= DRIFT_BAND:
        scale = min(max(sel_obs / prior_sel, 1.0 / _REFRESH_CLAMP),
                    _REFRESH_CLAMP)
        updates["filter_selectivity"] = round(
            min(max(profile.filter_selectivity * scale, 0.01), 1.0), 4)
    if margin_need is not None:
        base = (profile.compact_margin
                if profile.compact_margin is not None else None)
        from repro_torch.analytics.planner import COMPACT_MARGIN
        cur = base if base is not None else COMPACT_MARGIN
        new = min(max(margin_need, 1.0), _REFRESH_CLAMP)
        if not (1.0 / DRIFT_BAND) <= new / cur <= DRIFT_BAND:
            updates["compact_margin"] = round(new, 4)
    if not updates:
        return profile
    return dataclasses.replace(profile, source="telemetry", **updates)


# ---------------------------------------------------------------------------
# explain_analyze
# ---------------------------------------------------------------------------
def _annotation(ns: Optional[NodeStats]) -> str:
    if ns is None or not ns.last:
        return ""
    order = ("alive_in", "moved", "alive_out", "probe_alive", "build_alive",
             "out_alive", "groups_occupied", "overflow")
    obs = " ".join(f"{k}={ns.last[k]}" for k in order if k in ns.last)
    est = " ".join(f"{k}~{v}" for k, v in ns.est.items())
    return f"[obs {obs}" + (f" | est {est}]" if est else "]")


def _time_weight(node: PH.PNode) -> float:
    """Deterministic relative time weight of one physical node — the cost
    model's row terms (rows produced + wire rows, movement priced double).
    Per-node wall time is not observed (the launches are asynchronous);
    the plan's wall is apportioned by these static weights instead, which
    keeps the rendering golden-snapshotable."""
    w = float(max(getattr(node, "rows", 0), 0))
    if isinstance(node, PH.Exchange):
        w += 2.0 * max(node.moved_rows, 0)
    return max(w, 1.0)


def explain_analyze(plan, tables, ctx=None) -> str:
    """Execute ``plan`` under telemetry and render its physical tree with
    estimated-vs-observed rows per node — ``explain_physical`` made
    executable. Estimates are GLOBAL rows (per-shard node fields x
    n_shards); observations are the recorded totals of the run this call
    performed.

    The header carries the dispatch's wall time (the plan-level
    ``plan.execute`` grain tracing records); each node line carries its
    deterministic ``t~`` share of it (see ``_time_weight``). Deterministic
    for fixed tables up to the absolute wall, so golden-snapshotable with
    the wall normalized."""
    from repro_torch.analytics import planner

    ctx = ctx or planner.ExecutionContext()
    with recording() as reg:
        compiled = planner.compile_plan(plan, tables, ctx)
        compiled(tables)
        ps = reg.get(compiled.cache_key)
    by_node: Dict[PH.PNode, NodeStats] = {}
    if ps is not None:
        nodes = ps.node_list()
        for i, ns in ps.nodes.items():
            by_node[nodes[i]] = ns
    wall = (ps.wall_s[-1] if ps is not None and ps.wall_s else 0.0)
    uniq = list(PH.walk_unique(compiled.physical.root))
    total_w = sum(_time_weight(n) for n in uniq) or 1.0
    pct = {n: 100.0 * _time_weight(n) / total_w for n in uniq}

    def annotate(n: PH.PNode) -> str:
        t = f"[t~{pct.get(n, 0.0):.1f}%]"
        obs = _annotation(by_node.get(n))
        return f"{t} {obs}" if obs else t

    out = PH.describe(compiled.physical, annotate=annotate)
    head, _, rest = out.partition("\n")
    return f"{head} wall={wall * 1e3:.2f}ms\n{rest}"
