"""TPC-H-style workload on PyTorch: generated tables, the seven logical
query plans of ``repro.analytics.tpch`` run through the port's planner,
and the same seven queries written by hand on the columnar operators.

Tables: lineitem 6000*SF rows, orders 1500*SF, customer 150*SF, supplier
10*SF, nation 25, region 5. Dates are day-number ints; strings are
dictionary-encoded ints. ``generate`` makes the same numpy arrays as the
reference (the same ``RandomState`` call sequence) and puts them on a
device: a CUDA device unless the caller asks for another. Without a GPU
the default raises; it never falls back to the CPU.

The hand-written queries (``q1`` ... ``qq``, ``QUERIES``) are a second,
independent path to the same results: the planner's plans are held
against them. They run where their tables lie.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.analytics import planner
from repro_torch.analytics.columnar import Table, group_aggregate, pkfk_join
from repro_torch.analytics.plan import LogicalPlan, TableRows, col, scan
from repro_torch.core.config import resolve_device

N_NATION, N_REGION = 25, 5
N_SEGMENTS = 5
DATE0, DATE1 = 0, 2557            # ~7 years of day numbers

Tables = Mapping[str, Mapping[str, torch.Tensor]]


@dataclass(frozen=True)
class TPCHData:
    """Generated tables as {table: {column: tensor}} on one device."""
    tables: Dict[str, Dict[str, torch.Tensor]]
    scale: float


def generate_numpy(scale: float = 0.01,
                   seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """The reference generator's numpy arrays, call for call."""
    rng = np.random.RandomState(seed)
    n_li = max(1000, int(6_000_000 * scale))
    n_ord = max(250, int(1_500_000 * scale))
    n_cust = max(64, int(150_000 * scale))
    n_supp = max(16, int(10_000 * scale))

    nation = {
        "n_nationkey": np.arange(N_NATION, dtype=np.int32),
        "n_regionkey": rng.randint(0, N_REGION, N_NATION).astype(np.int32),
    }
    customer = {
        "c_custkey": np.arange(n_cust, dtype=np.int32),
        "c_nationkey": rng.randint(0, N_NATION, n_cust).astype(np.int32),
        "c_mktsegment": rng.randint(0, N_SEGMENTS, n_cust).astype(np.int32),
    }
    supplier = {
        "s_suppkey": np.arange(n_supp, dtype=np.int32),
        "s_nationkey": rng.randint(0, N_NATION, n_supp).astype(np.int32),
    }
    orders = {
        "o_orderkey": np.arange(n_ord, dtype=np.int32),
        "o_custkey": rng.randint(0, n_cust, n_ord).astype(np.int32),
        "o_orderdate": rng.randint(DATE0, DATE1, n_ord).astype(np.int32),
    }
    lineitem = {
        "l_orderkey": rng.randint(0, n_ord, n_li).astype(np.int32),
        "l_suppkey": rng.randint(0, n_supp, n_li).astype(np.int32),
        "l_quantity": rng.randint(1, 51, n_li).astype(np.float32),
        "l_extendedprice": (rng.rand(n_li) * 1e4).astype(np.float32),
        "l_discount": (rng.randint(0, 11, n_li) / 100).astype(np.float32),
        "l_tax": (rng.randint(0, 9, n_li) / 100).astype(np.float32),
        "l_returnflag": rng.randint(0, 3, n_li).astype(np.int32),
        "l_linestatus": rng.randint(0, 2, n_li).astype(np.int32),
        "l_shipdate": rng.randint(DATE0, DATE1, n_li).astype(np.int32),
    }
    return {"nation": nation, "customer": customer, "supplier": supplier,
            "orders": orders, "lineitem": lineitem}


def from_numpy(tables: Mapping[str, Mapping[str, np.ndarray]], scale: float,
               device: Union[None, str, torch.device] = None) -> TPCHData:
    """The port's tables from {table: {column: numpy array}} (the
    reference's ``TPCHData.tables``), copied onto ``device``."""
    dev = resolve_device(device)
    return TPCHData({t: {c: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for c, a in cols.items()}
                     for t, cols in tables.items()}, scale)


def generate(scale: float = 0.01, seed: int = 0,
             device: Union[None, str, torch.device] = None) -> TPCHData:
    """The reference's tables at ``scale`` from ``seed``, on ``device``
    (the CUDA device unless the caller names another; checked before
    generating)."""
    dev = resolve_device(device)
    return from_numpy(generate_numpy(scale, seed), scale, dev)


def _t(tables: Tables, name: str) -> Table:
    return Table(dict(tables[name]))


# ---------------------------------------------------------------------------
# hand-written queries (each returns a dict of result tensors); the float
# expressions keep the reference's operation order
# ---------------------------------------------------------------------------
def q1(tables: Tables, *, executor: str = "xla",
       cutoff: int = DATE1 - 90) -> Dict[str, torch.Tensor]:
    """Pricing summary: filter shipdate, group by (returnflag, linestatus).

    Seven aggregates over one key: under ``kernel`` all of them are one
    sweep of lineitem through the fused aggregate."""
    li = _t(tables, "lineitem")
    li = li.filter(li.col("l_shipdate") <= cutoff)
    g = li.col("l_returnflag") * 2 + li.col("l_linestatus")
    li = li.with_columns(
        _g=g,
        _disc_price=li.col("l_extendedprice") * (1 - li.col("l_discount")),
    )
    li = li.with_columns(_charge=li.col("_disc_price") * (1 + li.col("l_tax")))
    return group_aggregate(li, "_g", 6, {
        "sum_qty": ("sum", "l_quantity"),
        "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", "_disc_price"),
        "sum_charge": ("sum", "_charge"),
        "avg_qty": ("avg", "l_quantity"),
        "avg_price": ("avg", "l_extendedprice"),
        "count_order": ("count", "l_quantity"),
    }, executor=executor)


def q3(tables: Tables, *, executor: str = "xla", segment: int = 1,
       date: int = DATE1 // 2) -> Dict[str, torch.Tensor]:
    """Shipping priority: cust ⋈ orders ⋈ lineitem, top-10 revenue orders
    (ties to the lowest order key, as ``lax.top_k``)."""
    cust = _t(tables, "customer")
    cust = cust.filter(cust.col("c_mktsegment") == segment)
    orders = _t(tables, "orders")
    orders = orders.filter(orders.col("o_orderdate") < date)
    o = pkfk_join(orders, cust, "o_custkey", "c_custkey", {})
    li = _t(tables, "lineitem")
    li = li.filter(li.col("l_shipdate") > date)
    li = pkfk_join(li, o, "l_orderkey", "o_orderkey", {})
    li = li.with_columns(
        _rev=li.col("l_extendedprice") * (1 - li.col("l_discount")))
    n_ord = tables["orders"]["o_orderkey"].shape[0]
    agg = group_aggregate(li, "l_orderkey", n_ord,
                          {"revenue": ("sum", "_rev")}, executor=executor)
    top_rev, top_keys = planner.top_k(agg["revenue"], 10)
    return {"revenue": top_rev, "o_orderkey": top_keys,
            "_overflow": agg["_overflow"]}


def q5(tables: Tables, *, executor: str = "xla", region: int = 2,
       date_lo: int = 0, date_hi: int = 365) -> Dict[str, torch.Tensor]:
    """Local supplier volume: 5-way join, group by nation."""
    nation = _t(tables, "nation")
    nation = nation.filter(nation.col("n_regionkey") == region)
    cust = pkfk_join(_t(tables, "customer"), nation, "c_nationkey",
                     "n_nationkey", {})
    orders = _t(tables, "orders")
    orders = orders.filter((orders.col("o_orderdate") >= date_lo)
                           & (orders.col("o_orderdate") < date_hi))
    o = pkfk_join(orders, cust, "o_custkey", "c_custkey",
                  {"_c_nation": "c_nationkey"})
    li = pkfk_join(_t(tables, "lineitem"), o, "l_orderkey", "o_orderkey",
                   {"_c_nation": "_c_nation"})
    li = pkfk_join(li, _t(tables, "supplier"), "l_suppkey", "s_suppkey",
                   {"_s_nation": "s_nationkey"})
    # local: supplier nation == customer nation
    li = li.filter(li.col("_s_nation") == li.col("_c_nation"))
    li = li.with_columns(
        _rev=li.col("l_extendedprice") * (1 - li.col("l_discount")))
    return group_aggregate(li, "_s_nation", N_NATION,
                           {"revenue": ("sum", "_rev")}, executor=executor)


def q6(tables: Tables, *, executor: str = "xla", date_lo: int = 0,
       date_hi: int = 365, disc: float = 0.06,
       qty: float = 24.0) -> Dict[str, torch.Tensor]:
    """Forecast revenue change: one masked reduction, the same under
    every executor (the knob is taken for a uniform interface)."""
    del executor
    li = _t(tables, "lineitem")
    pred = ((li.col("l_shipdate") >= date_lo) & (li.col("l_shipdate") < date_hi)
            & (torch.abs(li.col("l_discount") - disc) <= 0.011)
            & (li.col("l_quantity") < qty))
    li = li.filter(pred)
    w = li.weights()
    rev = (li.col("l_extendedprice") * li.col("l_discount") * w).sum()
    return {"revenue": rev[None]}


def q18(tables: Tables, *, executor: str = "xla",
        qty_threshold: float = 212.0) -> Dict[str, torch.Tensor]:
    """Large volume customer: big group-by on orderkey, HAVING, re-join."""
    li = _t(tables, "lineitem")
    n_ord = tables["orders"]["o_orderkey"].shape[0]
    per_order = group_aggregate(li, "l_orderkey", n_ord,
                                {"qty": ("sum", "l_quantity")},
                                executor=executor)
    big = per_order["qty"] > qty_threshold
    orders = _t(tables, "orders").with_columns(_qty=per_order["qty"])
    # HAVING replaces the orders' selection (it has none of its own)
    orders = Table(orders.columns, big.to(torch.float32), orders.index_cache)
    o = pkfk_join(orders, _t(tables, "customer"), "o_custkey", "c_custkey",
                  {"_nat": "c_nationkey"})
    n_cust = tables["customer"]["c_custkey"].shape[0]
    out = group_aggregate(o, "o_custkey", n_cust, {"qty": ("sum", "_qty")},
                          executor=executor)
    # overflow in EITHER pass makes the result incomplete: never silent
    out["_overflow"] = out["_overflow"] + per_order["_overflow"]
    return out


def qm(tables: Tables, *, executor: str = "xla",
       cutoff: int = DATE1 - 90) -> Dict[str, torch.Tensor]:
    """Order-statistic pricing summary: per-returnflag MEDIAN quantity and
    price beside distributive companions (medians stay on the sort-based
    selection under every executor)."""
    li = _t(tables, "lineitem")
    li = li.filter(li.col("l_shipdate") <= cutoff)
    return group_aggregate(li, "l_returnflag", 3, {
        "med_qty": ("median", "l_quantity"),
        "med_price": ("median", "l_extendedprice"),
        "avg_qty": ("avg", "l_quantity"),
        "count_order": ("count", "l_quantity"),
    }, executor=executor)


def qq(tables: Tables, *, executor: str = "xla",
       cutoff: int = DATE1 - 90) -> Dict[str, torch.Tensor]:
    """Quantile pricing summary: per-returnflag p90 price and p25 quantity
    beside their median and count."""
    li = _t(tables, "lineitem")
    li = li.filter(li.col("l_shipdate") <= cutoff)
    return group_aggregate(li, "l_returnflag", 3, {
        "p90_price": ("quantile:0.9", "l_extendedprice"),
        "p25_qty": ("quantile:0.25", "l_quantity"),
        "med_price": ("median", "l_extendedprice"),
        "count_order": ("count", "l_quantity"),
    }, executor=executor)


QUERIES: Dict[str, Callable[..., Dict[str, torch.Tensor]]] = {
    "q1": q1, "q3": q3, "q5": q5, "q6": q6, "q18": q18, "qm": qm, "qq": qq}


# ---------------------------------------------------------------------------
# logical plans: the reference's queries, authored once against the plan IR
# ---------------------------------------------------------------------------
def build_q1(cutoff: int = DATE1 - 90) -> LogicalPlan:
    li = scan("lineitem").filter(col("l_shipdate") <= cutoff)
    li = li.project(
        _g=col("l_returnflag") * 2 + col("l_linestatus"),
        _disc_price=col("l_extendedprice") * (1 - col("l_discount")))
    li = li.project(_charge=col("_disc_price") * (1 + col("l_tax")))
    root = li.aggregate(
        "_g", 6,
        sum_qty=("sum", "l_quantity"),
        sum_base_price=("sum", "l_extendedprice"),
        sum_disc_price=("sum", "_disc_price"),
        sum_charge=("sum", "_charge"),
        avg_qty=("avg", "l_quantity"),
        avg_price=("avg", "l_extendedprice"),
        count_order=("count", "l_quantity"))
    return LogicalPlan(root, ("sum_qty", "sum_base_price", "sum_disc_price",
                              "sum_charge", "avg_qty", "avg_price",
                              "count_order", "_count", "_overflow"))


def build_q3(segment: int = 1, date: int = DATE1 // 2) -> LogicalPlan:
    cust = scan("customer").filter(col("c_mktsegment").eq(segment))
    orders = scan("orders").filter(col("o_orderdate") < date)
    o = orders.join(cust, "o_custkey", "c_custkey")
    li = scan("lineitem").filter(col("l_shipdate") > date)
    li = li.join(o, "l_orderkey", "o_orderkey")
    li = li.project(_rev=col("l_extendedprice") * (1 - col("l_discount")))
    agg = li.aggregate("l_orderkey", TableRows("orders"),
                       revenue=("sum", "_rev"))
    return LogicalPlan(agg.top_k("revenue", 10, "o_orderkey"),
                       ("revenue", "o_orderkey", "_overflow"))


def build_q5(region: int = 2, date_lo: int = 0,
             date_hi: int = 365) -> LogicalPlan:
    nation = scan("nation").filter(col("n_regionkey").eq(region))
    cust = scan("customer").join(nation, "c_nationkey", "n_nationkey")
    orders = scan("orders").filter((col("o_orderdate") >= date_lo)
                                   & (col("o_orderdate") < date_hi))
    o = orders.join(cust, "o_custkey", "c_custkey",
                    {"_c_nation": "c_nationkey"})
    li = scan("lineitem").join(o, "l_orderkey", "o_orderkey",
                               {"_c_nation": "_c_nation"})
    li = li.join(scan("supplier"), "l_suppkey", "s_suppkey",
                 {"_s_nation": "s_nationkey"})
    li = li.filter(col("_s_nation").eq(col("_c_nation")))
    li = li.project(_rev=col("l_extendedprice") * (1 - col("l_discount")))
    root = li.aggregate("_s_nation", N_NATION, revenue=("sum", "_rev"))
    return LogicalPlan(root, ("revenue", "_count", "_overflow"))


def build_q6(date_lo: int = 0, date_hi: int = 365, disc: float = 0.06,
             qty: float = 24.0) -> LogicalPlan:
    pred = ((col("l_shipdate") >= date_lo) & (col("l_shipdate") < date_hi)
            & (abs(col("l_discount") - disc) <= 0.011)
            & (col("l_quantity") < qty))
    li = scan("lineitem").filter(pred)
    li = li.project(_x=col("l_extendedprice") * col("l_discount"))
    return LogicalPlan(li.aggregate(None, 1, revenue=("sum", "_x")),
                       ("revenue",))


def build_q18(qty_threshold: float = 212.0) -> LogicalPlan:
    per_order = scan("lineitem").aggregate(
        "l_orderkey", TableRows("orders"), qty=("sum", "l_quantity"))
    orders = scan("orders").attach(per_order, "o_orderkey", {"_qty": "qty"})
    orders = orders.filter(col("_qty") > qty_threshold)
    o = orders.join(scan("customer"), "o_custkey", "c_custkey",
                    {"_nat": "c_nationkey"})
    root = o.aggregate("o_custkey", TableRows("customer"),
                       qty=("sum", "_qty"))
    return LogicalPlan(root, ("qty", "_count", "_overflow"))


def build_qm(cutoff: int = DATE1 - 90) -> LogicalPlan:
    li = scan("lineitem").filter(col("l_shipdate") <= cutoff)
    root = li.aggregate(
        "l_returnflag", 3,
        med_qty=("median", "l_quantity"),
        med_price=("median", "l_extendedprice"),
        avg_qty=("avg", "l_quantity"),
        count_order=("count", "l_quantity"))
    return LogicalPlan(root, ("med_qty", "med_price", "avg_qty",
                              "count_order", "_count", "_overflow"))


def build_qq(cutoff: int = DATE1 - 90) -> LogicalPlan:
    li = scan("lineitem").filter(col("l_shipdate") <= cutoff)
    root = li.aggregate(
        "l_returnflag", 3,
        p90_price=("quantile:0.9", "l_extendedprice"),
        p25_qty=("quantile:0.25", "l_quantity"),
        med_price=("median", "l_extendedprice"),
        count_order=("count", "l_quantity"))
    return LogicalPlan(root, ("p90_price", "p25_qty", "med_price",
                              "count_order", "_count", "_overflow"))


LOGICAL_QUERIES: Dict[str, LogicalPlan] = {
    "q1": build_q1(), "q3": build_q3(), "q5": build_q5(), "q6": build_q6(),
    "q18": build_q18(), "qm": build_qm(), "qq": build_qq()}


# ---------------------------------------------------------------------------
# execution through the cost-based planner (plan cache lives in planner.py)
# ---------------------------------------------------------------------------
plan_cache_size = planner.plan_cache_size
plan_cache_info = planner.plan_cache_info
clear_plan_cache = planner.clear_plan_cache
configure_plan_cache = planner.configure_plan_cache


def _tables(data, device) -> Tables:
    """Tensors of ``data``: a TPCHData or a {table: {column: tensor or
    numpy array}} mapping; numpy columns go to ``device`` (default CUDA)."""
    if isinstance(data, TPCHData):
        return data.tables
    if all(isinstance(a, torch.Tensor)
           for cols in data.values() for a in cols.values()):
        return data
    dev = resolve_device(device)
    return {t: {c: torch.as_tensor(a).to(dev) for c, a in cols.items()}
            for t, cols in data.items()}


def get_plan(name: str, executor: str) -> Callable:
    """Callable running ``name``'s logical plan under ``executor`` on the
    tables it is given."""
    ctx = planner.ExecutionContext(executor=executor)
    return lambda tbls: planner.execute_plan(LOGICAL_QUERIES[name], tbls, ctx)


def submit_query(service, name: str, data, *, executor: str = "xla",
                 context: Optional[planner.ExecutionContext] = None,
                 deadline_s: Optional[float] = None,
                 client_id: int = 0, priority: int = 1,
                 device: Union[None, str, torch.device] = None
                 ) -> Optional[int]:
    """Admit one of the TPC-H logical plans into an AnalyticsService.

    The concurrent-serving counterpart of ``run_query``, with the same
    query names, knobs and defaults, and the same placement of ``data``
    (tensors where they lie, numpy columns to ``device``, the CUDA device
    unless the caller names another). Non-blocking: returns the request
    id (collect via ``service.drain()``), or None under backpressure.
    Served results on the whole-plan path are bit-identical to
    ``run_query`` with the same context: both run the planner's
    plan-cache entry on the same tables."""
    tables = _tables(data, device)
    ctx = context or planner.ExecutionContext(executor=executor)
    return service.submit(LOGICAL_QUERIES[name], tables, context=ctx,
                          deadline_s=deadline_s, client_id=client_id,
                          priority=priority)


def run_query(name: str, data, *, executor: str = "xla",
              context: Optional[planner.ExecutionContext] = None,
              device: Union[None, str, torch.device] = None
              ) -> Dict[str, torch.Tensor]:
    """Execute a query's logical plan through the cost-based planner.

    ``data`` is a TPCHData or a {table: {column: array}} mapping; tensors
    run where they lie, numpy columns are copied to ``device`` (the CUDA
    device unless the caller names another). ``executor`` ("xla" |
    "kernel" | "cost") is shorthand for ``ExecutionContext(executor=...)``;
    a full ``context`` overrides it."""
    tables = _tables(data, device)
    ctx = context or planner.ExecutionContext(executor=executor)
    return planner.execute_plan(LOGICAL_QUERIES[name], tables, ctx)
