"""Memory-allocator microbenchmark (paper Section 3.1.8 / Figure 2).

A copy of ``repro.memory.microbench`` (numpy only) over the port's
allocators. Every field but the two times is a function of the seed and
the arguments, and equals the reference's.

Simulates the paper's allocation storm: ``n_streams`` concurrent allocation
streams interleaved round-robin, each performing ``ops_per_stream``
operations — allocate-and-write or read-and-free — with allocation sizes
drawn inversely proportional to the size class (small allocations dominate,
as in the paper). Metrics: wall-clock throughput (Fig 2a), contention
events (the scalability discriminator), memory overhead ratio (Fig 2b).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.config import AllocatorKind
from repro_torch.memory.allocators import make_allocator


@dataclass(frozen=True)
class MicrobenchResult:
    kind: str
    n_streams: int
    ops: int
    seconds: float
    ops_per_sec: float
    contentions: int
    contention_rate: float
    overhead_ratio: float
    failed: int


def _size_sampler(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Sizes in 64B..64KB with P(class) ∝ 1/size (paper's distribution);
    within a class, sizes are continuous so size-class rounding shows up
    as real memory overhead (paper Fig 2b)."""
    classes = 64 << np.arange(11)            # 64B .. 64KB
    weights = 1.0 / classes
    weights = weights / weights.sum()
    base = rng.choice(classes, size=n, p=weights)
    frac = rng.uniform(0.55, 1.0, size=n)
    return np.maximum((base * frac).astype(np.int64), 1)


def run_microbench(kind: AllocatorKind, *, n_streams: int = 8,
                   ops_per_stream: int = 5_000, capacity: int = 1 << 30,
                   granule: int = 64, seed: int = 0,
                   live_target: int = 64) -> MicrobenchResult:
    rng = np.random.RandomState(seed)
    alloc = make_allocator(kind, capacity=capacity, granule=granule)
    sizes = _size_sampler(rng, n_streams * ops_per_stream)
    live: List[List] = [[] for _ in range(n_streams)]
    total_ops = 0
    si = 0
    t0 = time.perf_counter()
    for i in range(ops_per_stream):
        for s in range(n_streams):
            # paper mix: alloc+write until a live target, then read+free
            if len(live[s]) >= live_target or (live[s] and rng.rand() < 0.45):
                blk = live[s].pop(rng.randint(len(live[s])))
                alloc.free(blk, stream=s)
            else:
                blk = alloc.alloc(int(sizes[si]), stream=s)
                si += 1
                if blk is not None:
                    live[s].append(blk)
            total_ops += 1
    dt = time.perf_counter() - t0
    st = alloc.stats
    return MicrobenchResult(
        kind=kind.value, n_streams=n_streams, ops=total_ops, seconds=dt,
        ops_per_sec=total_ops / dt,
        contentions=st.contentions,
        contention_rate=st.contentions / max(total_ops, 1),
        overhead_ratio=st.overhead_ratio,
        failed=st.failed)


def sweep(n_streams_list=(1, 2, 4, 8, 16, 32), **kw) -> List[MicrobenchResult]:
    out = []
    for kind in AllocatorKind:
        for n in n_streams_list:
            out.append(run_microbench(kind, n_streams=n, **kw))
    return out
