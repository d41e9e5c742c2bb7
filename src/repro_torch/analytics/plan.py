"""Logical plan IR for the analytics engine (W5 and user-authored queries).

The paper's thesis is that NUMA tuning — placement, partitioning, allocator
strategy — must apply *without rewriting the application*: the query stays
fixed while the execution strategy changes underneath it.  This module is
the "query stays fixed" half: a small relational IR whose nodes carry only
*what* to compute.  Every node is a frozen (hashable, structurally
comparable) dataclass, so a whole plan doubles as a plan-cache key and can
be inspected by the physical planner (planner.py), which picks *how* to
compute each node — XLA segment ops vs the fused Pallas kernel, sorted
gather vs join_probe-kernel probes, single device vs a placement-policy
shard_map backend — from a cost model over static shape metadata.

Relational nodes (produce a Table: struct-of-arrays + selection mask):

  Scan(table)                       named base table
  Filter(child, pred)               AND a predicate into the mask
  Project(child, cols)              add derived columns (expression IR)
  Join(probe, build, pk, bk, take)  PK-FK join; ``take`` gathers build cols
  Attach(child, source, key, cols)  gather Aggregate outputs back into a
                                    table through a dense group-id column
                                    (the HAVING/re-join idiom of Q18)

Aggregation nodes (produce a dict of (n_groups,) arrays):

  Aggregate(child, key, n_groups, aggs)   grouped sum/avg/count/max/min/
                                          median; key=None is a global
                                          aggregate
  TopK(child, col, k, index_name)         order-by-limit over a group dict

``median`` is the HOLISTIC (order-statistic) aggregate: it cannot be
computed from mergeable partials (paper Section 2), so the physical
planner lowers it onto a local-sort selection — and, under a placement
policy, onto full record replication or routed distributed selection —
instead of the fused distributive sweeps.

Scalar expressions (Filter predicates / Project columns) are their own tiny
IR — Col / Lit / BinOp / UnOp — with operator sugar so builders read like
the imperative code they replace::

    from repro_torch.analytics.plan import col, scan
    li = scan("lineitem").filter(col("l_shipdate") <= 1000)
    li = li.project(_rev=col("l_extendedprice") * (1 - col("l_discount")))
    q  = li.aggregate("l_returnflag", 3, revenue=("sum", "_rev"))

NOTE: ``==`` on plan/expression nodes is *structural equality* (needed for
cache keys); use ``Expr.eq()`` / ``Expr.ne()`` to build comparison
predicates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# scalar expression IR
# ---------------------------------------------------------------------------
class _ExprOps:
    """Operator sugar shared by every expression node.

    ``__eq__`` stays structural (dataclass) so expressions remain valid
    dict keys; build equality predicates with ``.eq()`` / ``.ne()``.
    """

    # arithmetic ------------------------------------------------------------
    def __add__(self, o): return BinOp("add", self, wrap(o))
    def __radd__(self, o): return BinOp("add", wrap(o), self)
    def __sub__(self, o): return BinOp("sub", self, wrap(o))
    def __rsub__(self, o): return BinOp("sub", wrap(o), self)
    def __mul__(self, o): return BinOp("mul", self, wrap(o))
    def __rmul__(self, o): return BinOp("mul", wrap(o), self)
    def __truediv__(self, o): return BinOp("div", self, wrap(o))
    def __neg__(self): return UnOp("neg", self)
    def __abs__(self): return UnOp("abs", self)
    # comparisons / boolean -------------------------------------------------
    def __le__(self, o): return BinOp("le", self, wrap(o))
    def __lt__(self, o): return BinOp("lt", self, wrap(o))
    def __ge__(self, o): return BinOp("ge", self, wrap(o))
    def __gt__(self, o): return BinOp("gt", self, wrap(o))
    def __and__(self, o): return BinOp("and", self, wrap(o))
    def __or__(self, o): return BinOp("or", self, wrap(o))
    def eq(self, o): return BinOp("eq", self, wrap(o))
    def ne(self, o): return BinOp("ne", self, wrap(o))


@dataclass(frozen=True)
class Col(_ExprOps):
    name: str


@dataclass(frozen=True)
class Lit(_ExprOps):
    value: Union[int, float, bool]


@dataclass(frozen=True)
class BinOp(_ExprOps):
    op: str          # add sub mul div le lt ge gt eq ne and or
    lhs: "Expr"
    rhs: "Expr"


@dataclass(frozen=True)
class UnOp(_ExprOps):
    op: str          # abs neg not
    operand: "Expr"


Expr = Union[Col, Lit, BinOp, UnOp]


def wrap(v) -> Expr:
    """Coerce a python scalar to Lit; pass expressions through."""
    if isinstance(v, (Col, Lit, BinOp, UnOp)):
        return v
    if isinstance(v, (int, float, bool)):
        return Lit(v)
    raise TypeError(f"cannot use {type(v).__name__} in a plan expression")


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


# ---------------------------------------------------------------------------
# cardinality references (resolved against table shapes at lowering time)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TableRows:
    """Group-domain size = row count of ``table`` (dense PK domains)."""
    table: str


Cardinality = Union[int, TableRows]


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------
class _NodeOps:
    """Fluent builders so logical plans read top-down."""

    def filter(self, pred: Expr) -> "Filter":
        return Filter(self, wrap(pred))

    def project(self, **cols: Expr) -> "Project":
        return Project(self, tuple((k, wrap(v)) for k, v in cols.items()))

    def join(self, build: "Node", probe_key: str, build_key: str,
             take: Mapping[str, str] = ()) -> "Join":
        return Join(self, build, probe_key, build_key,
                    tuple(dict(take).items()))

    def aggregate(self, key: Optional[str], n_groups: Cardinality,
                  **aggs: Tuple[str, str]) -> "Aggregate":
        return Aggregate(self, key, n_groups, tuple(aggs.items()))

    def attach(self, source: "Node", key: str,
               cols: Mapping[str, str]) -> "Attach":
        return Attach(self, source, key, tuple(dict(cols).items()))

    def top_k(self, col: str, k: int, index_name: str) -> "TopK":
        return TopK(self, col, k, index_name)


@dataclass(frozen=True)
class Scan(_NodeOps):
    table: str


@dataclass(frozen=True)
class Filter(_NodeOps):
    child: "Node"
    pred: Expr


@dataclass(frozen=True)
class Project(_NodeOps):
    child: "Node"
    cols: Tuple[Tuple[str, Expr], ...]


@dataclass(frozen=True)
class Join(_NodeOps):
    """PK-FK join: gather ``take`` (new_name -> build column) from the
    build side into the probe side; misses zero the probe row's mask."""
    probe: "Node"
    build: "Node"
    probe_key: str
    build_key: str
    take: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class Aggregate(_NodeOps):
    """Grouped aggregation. ``aggs``: out_name -> (op, column); op in
    {sum, avg, count, max, min, median}. ``key=None`` is a single global
    group (returns (1,) arrays). Results always carry ``_count``; the
    executor accumulates ``_overflow`` across every Aggregate in the
    plan."""
    child: "Node"
    key: Optional[str]
    n_groups: Cardinality
    aggs: Tuple[Tuple[str, Tuple[str, str]], ...]


@dataclass(frozen=True)
class TopK(_NodeOps):
    """Top-``k`` groups of ``child`` (an aggregation) by ``col``; group ids
    are emitted under ``index_name``."""
    child: "Node"
    col: str
    k: int
    index_name: str


@dataclass(frozen=True)
class Attach(_NodeOps):
    """Gather columns of an Aggregate ``source`` into ``child`` rows through
    the dense group-id column ``key`` (new_name -> source output name)."""
    child: "Node"
    source: "Node"
    key: str
    cols: Tuple[Tuple[str, str], ...]


Node = Union[Scan, Filter, Project, Join, Aggregate, TopK, Attach]


@dataclass(frozen=True)
class LogicalPlan:
    """A root node plus the result keys to emit (None = everything)."""
    root: Node
    outputs: Optional[Tuple[str, ...]] = None


def scan(table: str) -> Scan:
    return Scan(table)


# ---------------------------------------------------------------------------
# IR validation
# ---------------------------------------------------------------------------
AGG_OPS = ("sum", "avg", "count", "max", "min", "median", "distinct")
# "quantile:R" (R a literal rank in (0, 1), e.g. "quantile:0.9") is also a
# valid agg op: the arbitrary-rank generalization of median, riding the
# same sort-based selection machinery (columnar.segment_quantile).
# "distinct" is the exact per-group distinct-value count; it shares the
# selection sort (columnar.segment_distinct counts run boundaries in the
# value-sorted order) and is holistic — distinct counts cannot be merged
# from partials, so it lowers like median/quantile, not like a sum.
_BIN_OPS = ("add", "sub", "mul", "div", "le", "lt", "ge", "gt", "eq", "ne",
            "and", "or")
_UN_OPS = ("abs", "neg", "not")


def parse_quantile(op: str) -> Optional[float]:
    """Rank of a "quantile:R" agg op, or None for every other op.

    Raises ValueError when the op IS a quantile but the rank is not a
    literal in the OPEN interval (0, 1) — rank 0/1 are min/max, which have
    exact distributive lowerings and must be spelled that way."""
    if not isinstance(op, str) or not op.startswith("quantile:"):
        return None
    try:
        rank = float(op.split(":", 1)[1])
    except ValueError:
        raise ValueError(f"malformed quantile op {op!r}; "
                         f"expected 'quantile:R' with R a float") from None
    if not 0.0 < rank < 1.0:
        raise ValueError(f"quantile rank must be in (0, 1), got {rank} "
                         f"(use 'min'/'max' for the endpoints)")
    return rank


def is_holistic(op: str) -> bool:
    """True for sort-backed ops whose result cannot be merged from
    partials (paper Section 2): median, arbitrary-rank quantiles, and
    exact distinct counts."""
    return (op in ("median", "distinct")
            or parse_quantile(op) is not None)


def holistic_selector(op: str):
    """The selection parameter a holistic op feeds to the shared
    sort-selection machinery: None for median (the middle rank),
    a float rank in (0, 1) for quantiles, and the string "distinct"
    for the distinct-count (run-boundary sum over the same sorted
    order). Only valid for ops where ``is_holistic`` is True."""
    if op == "median":
        return None
    if op == "distinct":
        return "distinct"
    rank = parse_quantile(op)
    if rank is None:
        raise ValueError(f"not a holistic agg op: {op!r}")
    return rank


def _validate_expr(e: Expr) -> None:
    if isinstance(e, (Col, Lit)):
        return
    if isinstance(e, UnOp):
        if e.op not in _UN_OPS:
            raise ValueError(f"unknown unary op {e.op!r} in plan expression")
        _validate_expr(e.operand)
        return
    if isinstance(e, BinOp):
        if e.op not in _BIN_OPS:
            raise ValueError(f"unknown binary op {e.op!r} in plan expression")
        _validate_expr(e.lhs)
        _validate_expr(e.rhs)
        return
    raise TypeError(f"not a plan expression: {e!r}")


def validate(plan: Union["LogicalPlan", Node]) -> None:
    """Structural validation of a plan before it reaches the planner.

    Checks what can be known without table shapes: aggregate ops are from
    AGG_OPS, Aggregates are non-empty with positive literal group domains,
    TopK/Attach consume an aggregation (a group dict, not a Table), every
    Table-consuming input (Filter/Project/Aggregate child, Join sides,
    Attach child) really is a Table node, and every expression uses known
    operators. Raises ValueError/TypeError on the first violation; the
    planner calls this once per plan-cache miss, so malformed plans fail
    fast instead of dying inside a jit trace."""
    table_nodes = (Scan, Filter, Project, Join, Attach)

    def want_table(node: Node, input_name: str, child: Node) -> None:
        if not isinstance(child, table_nodes):
            raise ValueError(
                f"{type(node).__name__} {input_name} must be a Table node "
                f"(Scan/Filter/Project/Join/Attach), got a group dict from "
                f"{type(child).__name__}")

    root = plan.root if isinstance(plan, LogicalPlan) else plan
    for node in walk(root):
        if isinstance(node, Aggregate):
            want_table(node, "child", node.child)
            if not node.aggs:
                raise ValueError("Aggregate needs at least one aggregate")
            for name, (op, _col) in node.aggs:
                if op not in AGG_OPS and parse_quantile(op) is None:
                    raise ValueError(
                        f"unknown agg op {op!r} for {name!r}; "
                        f"expected one of {AGG_OPS} or 'quantile:R'")
            if (not isinstance(node.n_groups, TableRows)
                    and int(node.n_groups) < 1):
                raise ValueError(f"Aggregate n_groups must be >= 1, "
                                 f"got {node.n_groups!r}")
        elif isinstance(node, TopK):
            if not isinstance(node.child, (Aggregate, TopK)):
                raise ValueError("TopK must consume an Aggregate/TopK "
                                 "(a group dict), not a Table node")
            if node.k < 1:
                raise ValueError(f"TopK k must be >= 1, got {node.k}")
        elif isinstance(node, Attach):
            want_table(node, "child", node.child)
            if not isinstance(node.source, Aggregate):
                raise ValueError("Attach source must be an Aggregate")
            if not node.cols:
                raise ValueError("Attach needs at least one column")
        elif isinstance(node, Filter):
            want_table(node, "child", node.child)
            _validate_expr(node.pred)
        elif isinstance(node, Project):
            want_table(node, "child", node.child)
            for _name, e in node.cols:
                _validate_expr(e)
        elif isinstance(node, Join):
            want_table(node, "probe side", node.probe)
            want_table(node, "build side", node.build)


# ---------------------------------------------------------------------------
# introspection helpers
# ---------------------------------------------------------------------------
def children(node: Node) -> Tuple[Node, ...]:
    if isinstance(node, Scan):
        return ()
    if isinstance(node, (Filter, Project, Aggregate, TopK)):
        return (node.child,)
    if isinstance(node, Join):
        return (node.probe, node.build)
    if isinstance(node, Attach):
        return (node.child, node.source)
    raise TypeError(f"not a plan node: {node!r}")


def walk(node: Node):
    """Yield every node of the subtree, root first."""
    yield node
    for c in children(node):
        yield from walk(c)


def base_scan(node: Node, column: str) -> Optional[Scan]:
    """The Scan whose base table still carries ``column`` unchanged, or None.

    Follows derivations that preserve column identity (Filter; Project /
    Join-take / Attach when they do not (re)define ``column``); this is what
    lets a build-side sort index computed on the base table serve every
    filtered view of it.
    """
    while True:
        if isinstance(node, Scan):
            return node
        if isinstance(node, Filter):
            node = node.child
        elif isinstance(node, Project):
            if any(n == column for n, _ in node.cols):
                return None
            node = node.child
        elif isinstance(node, Join):
            if any(n == column for n, _ in node.take):
                return None
            node = node.probe
        elif isinstance(node, Attach):
            if any(n == column for n, _ in node.cols):
                return None
            node = node.child
        else:
            return None


def expr_cols(e: Expr) -> frozenset:
    """The set of column names an expression reads — the oracle the
    planner's Filter-below-Exchange peephole consults to decide whether a
    predicate only touches pre-route (probe-side) columns."""
    if isinstance(e, Col):
        return frozenset((e.name,))
    if isinstance(e, Lit):
        return frozenset()
    if isinstance(e, UnOp):
        return expr_cols(e.operand)
    return expr_cols(e.lhs) | expr_cols(e.rhs)


def expr_str(e: Expr) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, UnOp):
        return f"{e.op}({expr_str(e.operand)})"
    sym = {"add": "+", "sub": "-", "mul": "*", "div": "/", "le": "<=",
           "lt": "<", "ge": ">=", "gt": ">", "eq": "==", "ne": "!=",
           "and": "&", "or": "|"}[e.op]
    return f"({expr_str(e.lhs)} {sym} {expr_str(e.rhs)})"


def describe(plan: Union[LogicalPlan, Node], indent: int = 0) -> str:
    """Human-readable plan tree (used by planner.explain and examples)."""
    if isinstance(plan, LogicalPlan):
        return describe(plan.root)
    pad = "  " * indent
    if isinstance(plan, Scan):
        return f"{pad}Scan {plan.table}"
    if isinstance(plan, Filter):
        return (f"{pad}Filter {expr_str(plan.pred)}\n"
                + describe(plan.child, indent + 1))
    if isinstance(plan, Project):
        cols = ", ".join(f"{n}={expr_str(e)}" for n, e in plan.cols)
        return f"{pad}Project {cols}\n" + describe(plan.child, indent + 1)
    if isinstance(plan, Join):
        return (f"{pad}Join {plan.probe_key}={plan.build_key} "
                f"take={dict(plan.take)}\n"
                + describe(plan.probe, indent + 1) + "\n"
                + describe(plan.build, indent + 1))
    if isinstance(plan, Aggregate):
        aggs = ", ".join(f"{n}={op}({c})" for n, (op, c) in plan.aggs)
        return (f"{pad}Aggregate by {plan.key} [{plan.n_groups}] {aggs}\n"
                + describe(plan.child, indent + 1))
    if isinstance(plan, TopK):
        return (f"{pad}TopK {plan.k} by {plan.col}\n"
                + describe(plan.child, indent + 1))
    if isinstance(plan, Attach):
        return (f"{pad}Attach {dict(plan.cols)} via {plan.key}\n"
                + describe(plan.child, indent + 1) + "\n"
                + describe(plan.source, indent + 1))
    raise TypeError(f"not a plan node: {plan!r}")
