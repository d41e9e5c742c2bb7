"""The one generator that turns a traffic mix's parameters into requests.

A query stream (TPC-H clause 5.3.4's streams) runs the mix's queries
pass after pass, in the order the mix's ``orders`` gives it: stream i
takes ``orders[i]`` (cycling), as TPC-H's Appendix A fixes each stream's
order.
Each query's substitution parameters are drawn per request from the
mix's domains: ``[lo, hi]``, inclusive, of whole numbers or ISO dates (as
day numbers). A domain ``[v, v]`` fixes the parameter. Every pass holds
each query once, so every seed gives every stream the same mix of work.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np

from bench.days import day

WARMUP_STREAM = 1 << 20          # streams' numbers for the warm-up draws


def bound(v) -> int:
    return day(v) if isinstance(v, str) else int(v)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


def draw(domains: Mapping[str, list], g: np.random.Generator
         ) -> Dict[str, int]:
    out = {}
    for name in sorted(domains):
        lo, hi = (bound(v) for v in domains[name])
        out[name] = int(g.integers(lo, hi + 1))
    return out


def stream(traffic: Mapping, seed: int, index: int
           ) -> Iterator[Tuple[str, Dict[str, int]]]:
    """Endless (query, params) of stream ``index`` under ``seed``."""
    g = rng(seed, index)
    names = list(traffic["queries"])
    orders = traffic["orders"]
    order = list(orders[index % len(orders)])
    if sorted(order) != sorted(names):
        raise ValueError(f"stream {index}'s order {order} is not a "
                         f"permutation of {names}")
    while True:
        for name in order:
            yield name, draw(traffic["params"].get(name, {}), g)


def warmup_stream(traffic: Mapping, seed: int, index: int):
    """The warm-up's own draws, apart from the timed streams'."""
    return stream(traffic, seed, WARMUP_STREAM + index)
