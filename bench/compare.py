"""The comparison that decides ``correct``: a program's answer against
the reference's, as two numbers.

  rel_gap     the widest relative gap of any float output: |got - want| /
              |want| (|got| where want is 0); NaN matches NaN only
  mismatches  integer outputs (keys, counts of matches, overflow) that
              differ, plus outputs missing or of another shape

q3 returns the top 10 orders by revenue: its revenues are compared rank
by rank with the reference's top 10, and each returned key's revenue
with the reference's revenue of that key, so that a near-tie that puts
another order in the list reads as the tiny gap it is.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    g = np.asarray(got, dtype=np.float64).ravel()
    w = np.asarray(want, dtype=np.float64).ravel()
    if g.size == 0:
        return 0.0
    gn, wn = np.isnan(g), np.isnan(w)
    if np.any(gn != wn):
        return float("inf")
    if wn.any():
        g, w = g[~wn], w[~wn]
    if g.size == 0:
        return 0.0
    den = np.abs(w)
    return float(np.max(np.abs(g - w) / np.where(den > 0, den, 1.0)))


def same(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray]) -> bool:
    """Two answers that hold equal arrays, and so earn one verdict."""
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def judge(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]
          ) -> Tuple[float, int]:
    """(rel_gap, mismatches) of one answer; keys of ``want`` that start
    with "_order_" are the judge's own look-up tables."""
    gap, bad = 0.0, 0
    if "_order_revenue" in want:
        return judge_top_k(got, want)
    for name, w in want.items():
        w = np.asarray(w)
        if name not in got:
            bad += max(1, w.size)
            continue
        g = np.asarray(got[name])
        if g.shape != w.shape:
            bad += max(1, w.size)
            continue
        if np.issubdtype(g.dtype, np.integer) or g.dtype == np.bool_:
            bad += int(np.count_nonzero(g.astype(np.int64)
                                        != w.astype(np.int64)))
        else:
            gap = max(gap, rel_gap(g, w))
    return gap, bad


def judge_top_k(got: Mapping[str, np.ndarray],
                want: Mapping[str, np.ndarray]) -> Tuple[float, int]:
    per_order = want["_order_revenue"]
    k = np.asarray(want["revenue"]).size
    bad = 0
    rev = np.asarray(got.get("revenue", np.zeros(0)))
    keys = np.asarray(got.get("o_orderkey", np.zeros(0, dtype=np.int64)))
    if rev.shape != (k,) or keys.shape != (k,):
        return 0.0, k
    keys = keys.astype(np.int64)
    valid = (keys >= 0) & (keys < per_order.shape[0])
    bad += int(np.count_nonzero(~valid)) + (k - np.unique(keys).size)
    looked_up = np.full(k, np.nan)
    if np.any(valid):
        import torch
        idx = torch.as_tensor(keys[valid], device=per_order.device)
        looked_up[valid] = per_order[idx].cpu().numpy()
    gap = max(rel_gap(rev, want["revenue"]),
              rel_gap(rev[valid], looked_up[valid]))
    bad += int(np.count_nonzero(np.asarray(got.get("_overflow", 0))
                                != want["_overflow"]))
    return gap, bad
