"""The seven TPC-H-style queries on the port's plan IR, with their
substitution parameters: the benchmark's own copy of the definitions in
``repro_torch.analytics.tpch``, so that a change to the program cannot
move the yardstick.

Dates are day numbers, day 0 = 1992-01-01 (the port's encoding).
Parameters are the TPC-H ones mapped to that encoding:

  q1  delta     Q1's DELTA: cutoff = 1998-12-01 - delta days
  q3  segment   Q3's SEGMENT (dictionary code 0-4); date: Q3's DATE
  q5  region    Q5's REGION (code 0-4); year: Q5's DATE = Jan 1 of it
  q6  year      Q6's DATE; discount_pct: DISCOUNT in hundredths;
      quantity  Q6's QUANTITY
  q18 quantity  Q18's QUANTITY
  qm, qq delta  as q1 (the order-statistic companions of Q1)
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

from repro_torch.analytics.plan import LogicalPlan, TableRows, col, scan

from bench.days import Q1_BASE, year_range

N_NATION = 25


def q1(delta: int) -> LogicalPlan:
    cutoff = Q1_BASE - delta
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


def q3(segment: int, date: int) -> LogicalPlan:
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


def q5(region: int, year: int) -> LogicalPlan:
    date_lo, date_hi = year_range(year)
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


def q6(year: int, discount_pct: int, quantity: int) -> LogicalPlan:
    date_lo, date_hi = year_range(year)
    disc = discount_pct / 100
    pred = ((col("l_shipdate") >= date_lo) & (col("l_shipdate") < date_hi)
            & (abs(col("l_discount") - disc) <= 0.011)
            & (col("l_quantity") < float(quantity)))
    li = scan("lineitem").filter(pred)
    li = li.project(_x=col("l_extendedprice") * col("l_discount"))
    return LogicalPlan(li.aggregate(None, 1, revenue=("sum", "_x")),
                       ("revenue",))


def q18(quantity: int) -> LogicalPlan:
    per_order = scan("lineitem").aggregate(
        "l_orderkey", TableRows("orders"), qty=("sum", "l_quantity"))
    orders = scan("orders").attach(per_order, "o_orderkey", {"_qty": "qty"})
    orders = orders.filter(col("_qty") > float(quantity))
    o = orders.join(scan("customer"), "o_custkey", "c_custkey",
                    {"_nat": "c_nationkey"})
    root = o.aggregate("o_custkey", TableRows("customer"),
                       qty=("sum", "_qty"))
    return LogicalPlan(root, ("qty", "_count", "_overflow"))


def qm(delta: int) -> LogicalPlan:
    li = scan("lineitem").filter(col("l_shipdate") <= Q1_BASE - delta)
    root = li.aggregate(
        "l_returnflag", 3,
        med_qty=("median", "l_quantity"),
        med_price=("median", "l_extendedprice"),
        avg_qty=("avg", "l_quantity"),
        count_order=("count", "l_quantity"))
    return LogicalPlan(root, ("med_qty", "med_price", "avg_qty",
                              "count_order", "_count", "_overflow"))


def qq(delta: int) -> LogicalPlan:
    li = scan("lineitem").filter(col("l_shipdate") <= Q1_BASE - delta)
    root = li.aggregate(
        "l_returnflag", 3,
        p90_price=("quantile:0.9", "l_extendedprice"),
        p25_qty=("quantile:0.25", "l_quantity"),
        med_price=("median", "l_extendedprice"),
        count_order=("count", "l_quantity"))
    return LogicalPlan(root, ("p90_price", "p25_qty", "med_price",
                              "count_order", "_count", "_overflow"))


BUILDERS = {"q1": q1, "q3": q3, "q5": q5, "q6": q6, "q18": q18, "qm": qm,
            "qq": qq}


def plan(name: str, params: Mapping[str, int]) -> LogicalPlan:
    """The logical plan of query ``name`` at ``params``."""
    return BUILDERS[name](**params)


Key = Tuple[str, Tuple[Tuple[str, int], ...]]


def key(name: str, params: Mapping[str, int]) -> Key:
    """A hashable name for one query at one parameter set."""
    return name, tuple(sorted(params.items()))


def params_of(k: Key) -> Dict[str, int]:
    return dict(k[1])
