"""Physical plan IR: the explicit layer between logical plans and executors.

The paper's central claim is that data PLACEMENT AND MOVEMENT — not
compute — decide in-memory analytics performance on NUMA machines, and
that the profitable optimizations are cross-operator movement rewrites
(route once, aggregate before you ship, re-compact between hops). Those
rewrites need a representation where movement is a first-class node, not
an implementation detail buried inside an interpreter. This module is
that representation: ``planner.lower(plan, ctx)`` turns a logical plan
(plan.py) into a tree of the nodes below, every strategy decision —
join algorithm, aggregate layout, exchange kind, compaction point —
resolved to a plain field, and the executors in planner.py become thin
walkers that dispatch on node type.

Relational nodes (produce a Table per shard):

  PScan(table)                        base-table slice (row-sharded under
                                      a mesh, whole table locally)
  PFilter / PProject                  mask / derived columns (no movement)
  PJoin(probe, build, ..., strategy,  PK-FK join; ``strategy`` "sorted" |
        dist)                         "kernel"; ``dist`` records the
                                      distributed form ("broadcast" |
                                      "partitioned") for explain
  Exchange(child, kind, key, ...)     FIRST-CLASS DATA MOVEMENT:
                                        broadcast  all-gather a build side
                                        hash       all-to-all route rows to
                                                   their key's owner shard
                                        gather     converge all rows (the
                                                   PREFERRED policy plan)
                                      ``moved_rows`` is the estimated
                                      per-shard wire volume explain()
                                      reports; ``method`` picks the owner
                                      function ("hash" = multiplicative
                                      hash for clustered key spaces,
                                      "modulo" = the legacy dense-id map).
  Compact(child, capacity)            occupancy-aware re-compaction of a
                                      routed buffer: stable-partition the
                                      alive rows to the front and cut the
                                      buffer back to ``capacity`` rows, so
                                      chained partitioned joins stop
                                      growing padding multiplicatively
                                      (engine.compact_routed_rows).

Aggregation nodes (produce a replicated dict of (n_groups,) arrays):

  PPartialAggregate(child, ...)       per-shard (n_groups, C) stacked
                                      partial sums — the push-down half of
                                      a split distributive Aggregate
  PAggregate(child, ..., layout,      grouped/scalar aggregation; ``merge``
             merge, med_strategy)     names the distributed combine:
                                        None            single device
                                        "scalar"        psum'd globals
                                        "psum"          FIRST_TOUCH all-
                                                        reduce of partials
                                        "reduce_scatter" LOCAL_ALLOC
                                        "owner"         INTERLEAVE record
                                                        routing (child is a
                                                        hash Exchange)
                                        "pushdown"      partials routed by
                                                        group owner (child
                                                        is Exchange over
                                                        PPartialAggregate)
                                        "placed"        route-once: rows
                                                        already co-located
                                                        by the group key,
                                                        merge is a psum of
                                                        disjoint tables
                                        "gather"        PREFERRED converge
  PTopK / PAttach                     order-by-limit / group-result gather

Every node is a frozen dataclass — hashable and structurally comparable —
so executor memoization deduplicates structurally identical subtrees by
construction (two joins against the same build side share ONE routed
exchange), and the physical plan can live alongside the compiled
executable as the plan-cache value.

``rows`` is the node's PHYSICAL output rows per shard (buffer slots,
padding included); ``est`` is the estimated ALIVE rows per shard. The gap
between the two is what Compact reclaims, and what the rewrite rules in
this module (`maybe_pushdown`, `elide_exchange` via `placed_key`,
`maybe_compact`) consult.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

from repro_torch.analytics import plan as L


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PScan:
    table: str
    rows: int                 # physical rows per shard (padded under a mesh)
    est: int                  # estimated alive rows per shard


@dataclass(frozen=True)
class PFilter:
    """Row mask. ``pushed`` marks a filter the planner's
    Filter-below-Exchange peephole moved beneath a hash Exchange (it
    logically sat above the consuming join): rows it kills become dead
    padding BEFORE they reach the wire."""
    child: "PNode"
    pred: L.Expr
    rows: int
    est: int
    pushed: bool = False


@dataclass(frozen=True)
class PProject:
    child: "PNode"
    cols: Tuple[Tuple[str, L.Expr], ...]
    rows: int
    est: int


@dataclass(frozen=True)
class Exchange:
    """First-class data movement. ``kind``: "broadcast" (all-gather a build
    side), "hash" (all-to-all route rows to owner(``key``)), "gather"
    (converge all rows), "allreduce" (FIRST_TOUCH's psum of replicated
    (n_groups, C) partial tables: reduce-scatter + all-gather), or
    "reduce_scatter" (LOCAL_ALLOC's owner-sharded merge: the first half
    only). For hash exchanges ``capacity`` is the per-destination slot
    budget (output buffer = n_shards * capacity rows) and ``method`` the
    owner function; ``key=None`` marks a partial-sums exchange (rows are
    group ids, always modulo-owned). ``moved_rows`` is the estimated
    per-shard wire volume reported by explain(). "gather", "allreduce"
    and "reduce_scatter" execute FUSED inside the consuming PAggregate —
    the node exists so every policy's wire volume is priced on one
    axis. ``impl`` picks the routing layout pass for key-routing hash
    exchanges: "argsort" (stable argsort by owner) or "radix" (the
    radix-partition histogram kernel's prefix-sum layout,
    engine.radix_route_table_rows) — chosen by planner.lower per
    Exchange (exchange_costs) and bit-identical by construction."""
    child: "PNode"
    kind: str       # broadcast | hash | gather | allreduce | reduce_scatter
    key: Optional[str] = None
    capacity: int = 0
    method: str = "modulo"                  # hash | modulo owner function
    rows: int = 0
    est: int = 0
    moved_rows: int = 0
    impl: str = "argsort"                   # argsort | radix layout pass


@dataclass(frozen=True)
class Compact:
    """Occupancy-aware re-compaction of a routed buffer: keep the alive
    rows (stable order) in the first ``capacity`` slots, drop the rest of
    the padding. Alive rows beyond capacity are counted into the plan's
    ``_overflow`` (never silently dropped)."""
    child: "PNode"
    capacity: int
    rows: int                               # == capacity
    est: int


@dataclass(frozen=True)
class PJoin:
    """PK-FK join. ``morsel_split`` marks a LOCAL sorted-strategy probe
    phase the planner judged large enough to split into per-pool morsels
    (probe rows >= CostProfile.morsel_split_rows): the serving scheduler
    may then slice the probe side row-range-wise while the build side's
    pooled sort index is replicated once per worker pool
    (planner.probe_split / JoinIndexPool.replica). Purely advisory — the
    executors ignore it, so serial execution is untouched."""
    probe: "PNode"
    build: "PNode"
    probe_key: str
    build_key: str
    take: Tuple[Tuple[str, str], ...]
    strategy: str                           # sorted | kernel
    dist: Optional[str] = None              # None | broadcast | partitioned
    rows: int = 0
    est: int = 0
    morsel_split: bool = False              # probe phase is morsel-splittable


@dataclass(frozen=True)
class PPartialAggregate:
    """Per-shard (n_groups, C) stacked partial sums of the distributive
    aggregates — the below-the-exchange half of a pushed-down Aggregate."""
    child: "PNode"
    key: Optional[str]
    n_groups: int
    aggs: Tuple[Tuple[str, Tuple[str, str]], ...]
    layout: str                             # xla | dense | partitioned
    rows: int = 0                           # == n_groups
    est: int = 0


@dataclass(frozen=True)
class PAggregate:
    """Grouped (or scalar, ``key=None``) aggregation with every physical
    decision resolved: ``layout`` the local stacked-sums lowering,
    ``merge`` the distributed combine (see module docstring),
    ``med_strategy`` the holistic order-statistic plan ("replicate" |
    "route" | "placed" when the child is already co-located by the group
    key, so selection runs on the owner shard with no fresh Exchange |
    None when no median/quantile/distinct aggs)."""
    child: "PNode"
    key: Optional[str]
    n_groups: int
    aggs: Tuple[Tuple[str, Tuple[str, str]], ...]
    layout: str
    merge: Optional[str] = None
    med_strategy: Optional[str] = None
    rows: int = 0
    est: int = 0


@dataclass(frozen=True)
class PTopK:
    """Order-by-limit. ``dist`` records the distributed lowering:
    "replicated" selects on the merged (replicated) group table — free of
    movement of its own but only because the table was already replicated
    upstream; "candidates" selects each shard's local top-k over the group
    slots it owns and converges only k rows per shard through the child
    gather Exchange (k * n_shards candidate rows on the wire instead of
    the whole group table). None = single-device plan."""
    child: "PNode"
    col: str
    k: int
    index_name: str
    dist: Optional[str] = None              # None | replicated | candidates
    rows: int = 0
    est: int = 0


@dataclass(frozen=True)
class PAttach:
    child: "PNode"
    source: "PNode"
    key: str
    cols: Tuple[Tuple[str, str], ...]
    rows: int = 0
    est: int = 0


PNode = Union[PScan, PFilter, PProject, Exchange, Compact, PJoin,
              PPartialAggregate, PAggregate, PTopK, PAttach]


@dataclass(frozen=True)
class PhysicalPlan:
    """A physical root plus output selection and the mesh width it was
    lowered for (n_shards == 1 means a single-device plan)."""
    root: PNode
    outputs: Optional[Tuple[str, ...]] = None
    n_shards: int = 1


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------
def children(node: PNode) -> Tuple[PNode, ...]:
    if isinstance(node, PScan):
        return ()
    if isinstance(node, (PFilter, PProject, Exchange, Compact,
                         PPartialAggregate, PAggregate, PTopK)):
        return (node.child,)
    if isinstance(node, PJoin):
        return (node.probe, node.build)
    if isinstance(node, PAttach):
        return (node.child, node.source)
    raise TypeError(f"not a physical node: {node!r}")


def walk(node: PNode):
    """Yield every node of the subtree, root first (duplicates for shared
    structure — use walk_unique for movement accounting)."""
    yield node
    for c in children(node):
        yield from walk(c)


def walk_unique(node: PNode):
    """Yield each DISTINCT node once (structural identity) — the executor
    memoizes on structural equality, so this is what actually runs: two
    joins against the same build side share one routed Exchange."""
    seen = set()
    for n in walk(node):
        if n not in seen:
            seen.add(n)
            yield n


def exchanges(root: PNode) -> Tuple[Exchange, ...]:
    """Distinct Exchange nodes of a physical tree, plan order."""
    return tuple(n for n in walk_unique(root) if isinstance(n, Exchange))


def moved_rows(root: PNode) -> int:
    """Total estimated per-shard rows on the wire: the sum over DISTINCT
    exchanges (structural dedup = the route-once guarantee)."""
    return sum(e.moved_rows for e in exchanges(root))


# ---------------------------------------------------------------------------
# placement analysis (the route-once rewrite's oracle)
# ---------------------------------------------------------------------------
def placed_key(node: PNode) -> Optional[Tuple[str, str]]:
    """(key, owner_method) by which ``node``'s rows are already hash-placed
    across shards, or None.

    A hash Exchange places its output by its key; Filter/Project/Compact
    preserve placement (rows never move) unless a Project overwrites the
    key column; a partitioned PJoin's output rows ARE its routed probe
    rows, so the join preserves the probe side's placement. This is what
    lets the route-once rule skip an Exchange whose work an upstream
    Exchange already did."""
    while True:
        if isinstance(node, Exchange):
            if node.kind == "hash" and node.key is not None:
                return (node.key, node.method)
            return None
        if isinstance(node, Compact):
            node = node.child
        elif isinstance(node, PFilter):
            node = node.child
        elif isinstance(node, PProject):
            placed = placed_key(node.child)
            if placed is not None and any(n == placed[0]
                                          for n, _ in node.cols):
                return None          # key column overwritten
            return placed
        elif isinstance(node, PJoin):
            if node.dist is None:
                return None          # local join: no shard placement
            # a distributed join's output rows ARE its probe rows — a
            # partitioned join placed them via its probe Exchange, and a
            # broadcast join never moved them, so either way the probe
            # side's placement survives
            placed = placed_key(node.probe)
            if placed is not None and any(n == placed[0]
                                          for n, _ in node.take):
                return None          # take overwrote the key column
            return placed
        else:
            return None


def has_routed_buffer(node: PNode) -> bool:
    """True when ``node``'s ROWS include routed capacity padding (a hash
    Exchange over table rows feeds them), so occupancy-sensitive aggregate
    layouts (the range-partitioned fused kernel) must not be chosen on
    them. The walk stops at aggregation nodes: a PAggregate/PTopK output
    is a fresh replicated group table — an exchange buried below it never
    reaches the CURRENT row space (an Attach gathers only its columns)."""
    if isinstance(node, (PAggregate, PPartialAggregate, PTopK)):
        return False
    if isinstance(node, Exchange) and node.kind == "hash" \
            and node.key is not None:
        return True
    return any(has_routed_buffer(c) for c in children(node))


# ---------------------------------------------------------------------------
# rewrite rules (applied by planner.lower as it builds the tree)
# ---------------------------------------------------------------------------
def ceil128(n: int) -> int:
    """128-row tile rounding with a one-tile floor — THE slot-budget
    quantum: engine.routing_capacity and the Compact budgets both round
    through this one helper so routing capacities and compaction budgets
    can never desynchronize."""
    return max(128, -(-int(n) // 128) * 128)


def maybe_compact(child: PNode, margin: float, enabled: bool,
                  selectivity: float = 1.0) -> PNode:
    """Rule 3 — occupancy-aware compaction: before re-routing a buffer
    whose physical rows exceed its occupancy budget (``margin`` x
    estimated alive rows, 128-row tiles), insert a Compact so the next
    hash Exchange sizes its capacity from the COMPACTED rows. Without
    this, each hop of a chained partitioned join pads its successor's
    routing input by another capacity_factor (the ROADMAP padding-growth
    bug). ``margin`` is the occupancy-estimate headroom (COMPACT_MARGIN
    or the ExecutionContext.compact override), distinct from the routing
    capacity_factor, which absorbs per-destination routing skew.

    ``selectivity`` folds the (telemetry-refreshed) filter-selectivity
    estimate of the buffer's stacked PFilters into the budget — a buffer
    known to be mostly dead after filtering compacts tighter. The
    effective margin is CLAMPED at 1.0 x est: a mis-estimated selectivity
    may waste headroom, but it can never shrink the budget below the est
    the routing capacities were sized from (alive rows beyond the budget
    still surface as _overflow, never vanish)."""
    if not enabled:
        return child
    eff = max(margin * min(max(selectivity, 0.0), 1.0), 1.0)
    cap = ceil128(eff * max(child.est, 1))
    if cap >= child.rows:
        return child                 # buffer already tight: nothing to cut
    return Compact(child, capacity=cap, rows=cap, est=child.est)


def pushdown_profitable(n_groups: int, child_rows: int) -> bool:
    """Rule 1's cost test — aggregate push-down ships one partial-sums row
    per group instead of one row per record, so it wins exactly when the
    group domain is smaller than the per-shard input. Callers price
    ``child_rows`` as the estimated ALIVE input (est discounted by the
    profile's filter_selectivity per stacked PFilter), so a drifted
    selectivity refreshed by telemetry moves the crossover."""
    return n_groups < child_rows


def filters_below(node: PNode) -> int:
    """Number of PFilter nodes stacked directly below ``node`` (through
    Project/Compact wrappers). The Exchange moved-rows estimate consults
    this: a filter's est is NOT discounted (capacity/compact budgets must
    stay occupancy-safe), so each filter on the path instead multiplies
    the priced wire payload by the profile's filter_selectivity. The walk
    stops at any node that produces fresh rows (scan, join, exchange,
    aggregate)."""
    count = 0
    while True:
        if isinstance(node, PFilter):
            count += 1
            node = node.child
        elif isinstance(node, (PProject, Compact)):
            node = node.child
        else:
            return count


def routes_once(child: PNode, key: Optional[str]) -> bool:
    """Rule 2's test — True when ``child``'s rows are already co-located
    by ``key`` (an upstream hash Exchange on the same column did the
    work), so the Exchange a grouped INTERLEAVE Aggregate would insert can
    be elided: the records route ONE time for the join and the aggregate
    alike. The owner method does not matter here — any placement that
    co-locates a group's rows makes the disjoint-table psum merge exact."""
    if key is None:
        return False
    placed = placed_key(child)
    return placed is not None and placed[0] == key


# ---------------------------------------------------------------------------
# rendering (the explain() physical tree)
# ---------------------------------------------------------------------------
def describe(plan: Union[PhysicalPlan, PNode], indent: int = 0,
             annotate=None) -> str:
    """Deterministic physical-tree rendering: one line per node with its
    resolved strategy, buffer rows, and — for Exchange/Compact — the
    movement numbers. String-stable for fixed table shapes (golden-
    snapshot tested), so plans can be diffed across PRs. ``annotate``,
    when given, is a callable node -> str whose non-empty result is
    appended to that node's line (telemetry.explain_analyze uses it to
    print observed-vs-estimated rows per Decision)."""
    if isinstance(plan, PhysicalPlan):
        head = f"PhysicalPlan shards={plan.n_shards}"
        return head + "\n" + describe(plan.root, 1, annotate)
    pad = "  " * indent
    kids = children(plan)
    if isinstance(plan, PScan):
        line = f"PScan {plan.table} rows={plan.rows}"
    elif isinstance(plan, PFilter):
        line = f"PFilter {L.expr_str(plan.pred)}"
        if plan.pushed:
            line += " pushed=below-exchange"
    elif isinstance(plan, PProject):
        cols = ", ".join(f"{n}={L.expr_str(e)}" for n, e in plan.cols)
        line = f"PProject {cols}"
    elif isinstance(plan, Exchange):
        det = f"Exchange {plan.kind}"
        if plan.key is not None:
            det += f" key={plan.key} method={plan.method} impl={plan.impl}"
        elif plan.kind == "hash":
            det += " key=<group-partials>"
        if plan.capacity:
            det += f" capacity={plan.capacity}"
        line = f"{det} rows={plan.rows} moved~{plan.moved_rows}"
    elif isinstance(plan, Compact):
        line = (f"Compact capacity={plan.capacity} rows={plan.rows} "
                f"(from {plan.child.rows})")
    elif isinstance(plan, PJoin):
        det = f"PJoin {plan.probe_key}={plan.build_key} {plan.strategy}"
        if plan.dist:
            det += f" dist={plan.dist}"
        if plan.morsel_split:
            det += " morsel_split"
        line = f"{det} rows={plan.rows}"
    elif isinstance(plan, PPartialAggregate):
        line = (f"PPartialAggregate by {plan.key} groups={plan.n_groups} "
                f"layout={plan.layout}")
    elif isinstance(plan, PAggregate):
        aggs = ", ".join(f"{n}={op}({c})" for n, (op, c) in plan.aggs)
        det = f"PAggregate by {plan.key} groups={plan.n_groups} {aggs} " \
              f"layout={plan.layout}"
        if plan.merge:
            det += f" merge={plan.merge}"
        if plan.med_strategy:
            det += f" med={plan.med_strategy}"
        line = det
    elif isinstance(plan, PTopK):
        line = f"PTopK {plan.k} by {plan.col}"
        if plan.dist:
            line += f" dist={plan.dist}"
    elif isinstance(plan, PAttach):
        line = f"PAttach {dict(plan.cols)} via {plan.key}"
    else:
        raise TypeError(f"not a physical node: {plan!r}")
    if annotate is not None:
        extra = annotate(plan)
        if extra:
            line += " " + extra
    out = pad + line
    for c in kids:
        out += "\n" + describe(c, indent + 1, annotate)
    return out
