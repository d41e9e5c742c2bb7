"""Plain PyTorch reference of the seven queries: each answer worked out
again from the tables the program was handed, in float64 (or, for the
control, in a lower precision). It imports nothing of the program.

The semantics are the port's documented ones: fixed group domains (q1's
6 = returnflag x 2 + linestatus, qm/qq's 3 returnflags, q5's 25 nations,
q18's customers), an average over an empty group is 0, a median or
quantile of one is NaN, quantiles interpolate linearly (numpy's
default), a median is the mean of the two middle values. Answers come in
the program's output format ({name: numpy array}); q3 also hands the
judge every order's revenue, to look its returned keys up.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from bench.days import Q1_BASE, year_range

F64 = torch.float64
NO_OVERFLOW = np.array(0, dtype=np.int32)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype sums accumulate in: float64 for the reference; float32
    below it, as torch's own reductions of bf16 and fp16 accumulate."""
    return F64 if dtype == F64 else torch.float32


def group_sums(ids: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor,
               n: int, dtype: torch.dtype) -> torch.Tensor:
    """Per-group sums of ``vals`` (already in ``dtype``) over the rows
    where ``mask``, rounded to ``dtype``. The rows are selected first: a
    bin that took every excluded row would serialize their atomic adds."""
    out = torch.bincount(ids[mask], weights=vals[mask].to(acc_dtype(dtype)),
                         minlength=n)
    return out.to(dtype)


def group_counts(ids: torch.Tensor, mask: torch.Tensor, n: int
                 ) -> torch.Tensor:
    return torch.bincount(ids[mask], minlength=n)


def host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu").numpy()


def as_count(c: torch.Tensor, dtype: torch.dtype) -> np.ndarray:
    """A count in the precision under test (exact in float64)."""
    return host(c.to(dtype).to(F64))


def order_stat(nth: Callable[[int], torch.Tensor], n: int,
               rank: Optional[float], dtype: torch.dtype) -> float:
    """Median (rank None) or linear quantile of ``n`` values in ``dtype``,
    ``nth(k)`` giving the k-th smallest (from 0); NaN if there are none."""
    if n == 0:
        return float("nan")
    if rank is None:
        lo, hi = nth((n - 1) // 2), nth(n // 2)
        return float(((lo + hi) / 2).to(F64)) if dtype == F64 else \
            float((lo + hi) / 2)
    pos = rank * (n - 1)
    base = int(np.floor(pos))
    frac = pos - base
    lo, hi = nth(base), nth(min(base + 1, n - 1))
    if dtype == F64:
        return float(lo) + (float(hi) - float(lo)) * frac
    return float(lo + (hi - lo) * frac)


class Reference:
    """The seven answers over one set of tables, in ``dtype``. Columns and
    the per-row products the queries share are worked out once and kept."""

    def __init__(self, tables: Mapping[str, Mapping[str, torch.Tensor]],
                 dtype: torch.dtype = F64):
        self.t = tables
        self.dtype = dtype
        self._kept: Dict[tuple, object] = {}

    def _keep(self, key: tuple, make: Callable[[], object]):
        if key not in self._kept:
            self._kept[key] = make()
        return self._kept[key]

    def f(self, table: str, name: str) -> torch.Tensor:
        """A float column in the precision under test."""
        return self._keep(("f", table, name),
                          lambda: self.t[table][name].to(self.dtype))

    def i(self, table: str, name: str) -> torch.Tensor:
        return self._keep(("i", table, name),
                          lambda: self.t[table][name].to(torch.int64))

    def revenue(self) -> torch.Tensor:
        """l_extendedprice x (1 - l_discount), in the precision under test."""
        return self._keep(("revenue",), lambda: self.f(
            "lineitem", "l_extendedprice") * (
                1 - self.f("lineitem", "l_discount")))

    def answer(self, name: str, params: Mapping[str, int]
               ) -> Dict[str, np.ndarray]:
        return getattr(self, name)(**params)

    # -- the queries --------------------------------------------------------
    def q1(self, delta: int):
        d = self.dtype
        li = self.t["lineitem"]
        g = self._keep(("q1_group",), lambda: self.i(
            "lineitem", "l_returnflag") * 2 + self.i(
                "lineitem", "l_linestatus"))
        mask = li["l_shipdate"] <= Q1_BASE - delta
        qty, price = self.f("lineitem", "l_quantity"), self.f(
            "lineitem", "l_extendedprice")
        disc_price = self.revenue()
        charge = self._keep(("charge",), lambda: disc_price * (
            1 + self.f("lineitem", "l_tax")))
        cnt = group_counts(g, mask, 6)
        sums = {k: group_sums(g, mask, v, 6, d) for k, v in (
            ("sum_qty", qty), ("sum_base_price", price),
            ("sum_disc_price", disc_price), ("sum_charge", charge))}
        den = torch.clamp(cnt, min=1).to(d)
        out = {k: host(v.to(F64)) for k, v in sums.items()}
        out["avg_qty"] = host((sums["sum_qty"] / den).to(F64))
        out["avg_price"] = host((sums["sum_base_price"] / den).to(F64))
        out["count_order"] = out["_count"] = as_count(cnt, d)
        out["_overflow"] = NO_OVERFLOW
        return out

    def order_revenue(self, segment: int, date: int) -> torch.Tensor:
        """Q3's revenue of every order (0 where no line qualifies)."""
        cust_ok = self.t["customer"]["c_mktsegment"] == segment
        o = self.t["orders"]
        ord_ok = (o["o_orderdate"] < date) & cust_ok[o["o_custkey"].long()]
        li = self.t["lineitem"]
        lk = self.i("lineitem", "l_orderkey")
        n = o["o_orderkey"].shape[0]
        mask = (li["l_shipdate"] > date) & ord_ok[lk]
        return group_sums(lk, mask, self.revenue(), n, self.dtype)

    def q3(self, segment: int, date: int):
        per_order = self.order_revenue(segment, date)
        # ties to the lowest order key, as the port's top-k
        vals, idx = torch.sort(per_order, descending=True, stable=True)
        return {"revenue": host(vals[:10].to(F64)),
                "o_orderkey": host(idx[:10].to(torch.int32)),
                "_overflow": NO_OVERFLOW,
                "_order_revenue": per_order.to(F64)}

    def q5(self, region: int, year: int):
        lo, hi = year_range(year)
        nat_ok = self.t["nation"]["n_regionkey"] == region
        c_nat = self.i("customer", "c_nationkey")
        cust_ok = nat_ok[c_nat]
        o = self.t["orders"]
        ock = self.i("orders", "o_custkey")
        ord_ok = (o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi) \
            & cust_ok[ock]
        lk = self.i("lineitem", "l_orderkey")
        s_nat = self._keep(("s_nat",), lambda: self.i(
            "supplier", "s_nationkey")[self.i("lineitem", "l_suppkey")])
        same = self._keep(("same_nation",), lambda: s_nat == c_nat[ock][lk])
        mask = ord_ok[lk] & same
        return {"revenue": host(group_sums(s_nat, mask, self.revenue(), 25,
                                           self.dtype).to(F64)),
                "_count": as_count(group_counts(s_nat, mask, 25),
                                   self.dtype),
                "_overflow": NO_OVERFLOW}

    def q6(self, year: int, discount_pct: int, quantity: int):
        lo, hi = year_range(year)
        li = self.t["lineitem"]
        disc64 = self._keep(("disc64",), lambda: li["l_discount"].to(F64))
        mask = ((li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
                & ((disc64 - discount_pct / 100).abs() <= 0.011)
                & (li["l_quantity"] < quantity))
        x = self._keep(("price_x_disc",), lambda: self.f(
            "lineitem", "l_extendedprice") * self.f("lineitem", "l_discount"))
        zero = self._keep(("zero",), lambda: torch.zeros_like(
            mask, dtype=torch.int64))
        rev = group_sums(zero, mask, x, 1, self.dtype)
        return {"revenue": host(rev.to(F64))}

    def q18(self, quantity: int):
        d = self.dtype
        o = self.t["orders"]
        n_ord, n_cust = o["o_orderkey"].shape[0], \
            self.t["customer"]["c_custkey"].shape[0]
        def per_order():
            lk = self.i("lineitem", "l_orderkey")
            return group_sums(lk, torch.ones_like(lk, dtype=torch.bool),
                              self.f("lineitem", "l_quantity"), n_ord, d)
        qty = self._keep(("q18_per_order",), per_order)
        ock, big = self.i("orders", "o_custkey"), qty > quantity
        return {"qty": host(group_sums(ock, big, qty, n_cust, d).to(F64)),
                "_count": as_count(group_counts(ock, big, n_cust), d),
                "_overflow": NO_OVERFLOW}

    def _ranked(self, col: str, flag: int):
        """The values of ``col`` in rows of returnflag ``flag``, sorted (in
        the precision under test), with each one's ship date."""
        def make():
            li = self.t["lineitem"]
            rows = li["l_returnflag"] == flag
            v, order = torch.sort(self.f("lineitem", col)[rows])
            return v, li["l_shipdate"][rows][order]
        return self._keep(("ranked", col, flag), make)

    def _stats(self, delta: int, col: str, rank: Optional[float]):
        """Each returnflag's median or quantile of ``col`` over the rows
        shipped by Q1's cutoff: the k-th smallest of those rows is the
        k-th of the sorted values whose ship date is by the cutoff."""
        out = []
        for flag in range(3):
            v, ship = self._ranked(col, flag)
            seen = torch.cumsum(ship <= Q1_BASE - delta, 0)
            n = int(seen[-1]) if seen.numel() else 0
            out.append(order_stat(
                lambda k: v[torch.searchsorted(seen, k + 1)], n, rank,
                v.dtype))
        return np.array(out, dtype=np.float64)

    def _by_flag(self, delta: int):
        li = self.t["lineitem"]
        return (self.i("lineitem", "l_returnflag"),
                li["l_shipdate"] <= Q1_BASE - delta)

    def qm(self, delta: int):
        d = self.dtype
        flag, mask = self._by_flag(delta)
        cnt = group_counts(flag, mask, 3)
        sq = group_sums(flag, mask, self.f("lineitem", "l_quantity"), 3, d)
        return {"med_qty": self._stats(delta, "l_quantity", None),
                "med_price": self._stats(delta, "l_extendedprice", None),
                "avg_qty": host((sq / torch.clamp(cnt, min=1).to(d))
                                .to(F64)),
                "count_order": as_count(cnt, d),
                "_count": as_count(cnt, d),
                "_overflow": NO_OVERFLOW}

    def qq(self, delta: int):
        d = self.dtype
        cnt = group_counts(*self._by_flag(delta), 3)
        return {"p90_price": self._stats(delta, "l_extendedprice", 0.9),
                "p25_qty": self._stats(delta, "l_quantity", 0.25),
                "med_price": self._stats(delta, "l_extendedprice", None),
                "count_order": as_count(cnt, d),
                "_count": as_count(cnt, d),
                "_overflow": NO_OVERFLOW}
