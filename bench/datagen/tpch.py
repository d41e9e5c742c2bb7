"""TPC-H tables in the port's schema, drawn on the device from a seed.

dbgen's distributions (TPC-H specification, clause 4.2.3) on the port's
columns, with its dense 0-based keys and dictionary codes:

  orders    o_orderdate uniform over [1992-01-01, 1998-08-02]; o_custkey
            uniform over the customers whose 1-based key is not a
            multiple of 3 (dbgen leaves a third of them without orders)
  lineitem  clustered by order, 1-7 lines an order; l_shipdate = the
            order's date + 1..121 days; l_receiptdate (not kept) =
            l_shipdate + 1..30; l_returnflag R or A (codes 2, 0) when the
            receipt is on or before 1995-06-17, else N (1); l_linestatus
            O (1) when shipped after 1995-06-17, else F (0); l_quantity
            1..50; l_extendedprice = quantity x the part's retail price
            (dbgen's formula of a uniform part key); l_discount 0..0.10,
            l_tax 0..0.08 in hundredths; l_suppkey uniform
  customer  c_nationkey 0..24, c_mktsegment 0..4
  supplier  s_nationkey 0..24
  nation    n_regionkey as the specification's nation table

Lines per order are a fixed multiset (order i gets 1 + i mod 7 lines
before the shuffle), so every seed has the same number of lineitem rows
and the same work. All draws are on ``device`` from one
``torch.Generator``: the same seed gives the same tables.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from bench.days import day

# TPC-H specification, clause 4.2.3: the region of each of the 25 nations
NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                 3, 4, 2, 3, 3, 1)
LAST_ORDER_DAY = day("1998-08-02")
CURRENT_DAY = day("1995-06-17")
I32, F32, F64 = torch.int32, torch.float32, torch.float64


def lineitem_rows(n_orders: int) -> int:
    """Rows of lineitem for ``n_orders`` orders (the fixed multiset)."""
    full, rest = divmod(n_orders, 7)
    return 28 * full + rest * (rest + 1) // 2


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def make_tables(rows: Mapping[str, int], seed: int, device: torch.device
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{table: {column: tensor}} on ``device``; ``rows`` gives orders,
    customer, supplier and part (the part keys only price the lines)."""
    g = generator(seed, device)
    n_ord, n_cust = int(rows["orders"]), int(rows["customer"])
    n_supp, n_part = int(rows["supplier"]), int(rows["part"])

    def ints(lo, hi, n):            # uniform over [lo, hi], inclusive
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                             dtype=I32)

    nation = {"n_nationkey": torch.arange(25, dtype=I32, device=device),
              "n_regionkey": torch.tensor(NATION_REGION, dtype=I32,
                                          device=device)}
    customer = {"c_custkey": torch.arange(n_cust, dtype=I32, device=device),
                "c_nationkey": ints(0, 24, n_cust),
                "c_mktsegment": ints(0, 4, n_cust)}
    supplier = {"s_suppkey": torch.arange(n_supp, dtype=I32, device=device),
                "s_nationkey": ints(0, 24, n_supp)}
    # customers k with (k + 1) % 3 != 0: the r-th of them is r + r // 2
    active = n_cust - n_cust // 3
    r = ints(0, active - 1, n_ord)
    orders = {"o_orderkey": torch.arange(n_ord, dtype=I32, device=device),
              "o_custkey": r + r // 2,
              "o_orderdate": ints(0, LAST_ORDER_DAY, n_ord)}
    del r

    per_order = (torch.arange(n_ord, device=device) % 7 + 1)[
        torch.randperm(n_ord, generator=g, device=device)]
    n_li = lineitem_rows(n_ord)
    l_orderkey = torch.repeat_interleave(
        torch.arange(n_ord, dtype=I32, device=device), per_order,
        output_size=n_li)
    del per_order
    ship = orders["o_orderdate"][l_orderkey] + ints(1, 121, n_li)
    receipt = ship + ints(1, 30, n_li)
    returned = receipt <= CURRENT_DAY
    del receipt
    flag = torch.where(returned, ints(0, 1, n_li) * 2, 1).to(I32)
    del returned
    status = (ship > CURRENT_DAY).to(I32)
    qty = ints(1, 50, n_li)
    pk = ints(1, n_part, n_li).to(torch.int64)
    retail = (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)).to(F64) / 100
    del pk
    price = (qty.to(F64) * retail).to(F32)
    del retail
    lineitem = {
        "l_orderkey": l_orderkey,
        "l_suppkey": ints(0, n_supp - 1, n_li),
        "l_quantity": qty.to(F32),
        "l_extendedprice": price,
        "l_discount": (ints(0, 10, n_li).to(F64) / 100).to(F32),
        "l_tax": (ints(0, 8, n_li).to(F64) / 100).to(F32),
        "l_returnflag": flag,
        "l_linestatus": status,
        "l_shipdate": ship,
    }
    return {"nation": nation, "customer": customer, "supplier": supplier,
            "orders": orders, "lineitem": lineitem}


def table_bytes(tables: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size()
               for cols in tables.values() for t in cols.values())
