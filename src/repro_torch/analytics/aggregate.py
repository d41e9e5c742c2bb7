"""W1 (holistic MEDIAN) and W2 (distributive COUNT) aggregation operators:
the port of ``repro.analytics.aggregate``.

  count_direct       plain segment sums (the oracle and small inputs).
  count_partitioned  range partitioning, then the hash_aggregate kernel
                     per partition (``columnar.stacked_group_sums`` with
                     the "partitioned" layout): on a CUDA tensor it
                     launches ``hash_aggregate_multi``.
  median_direct      a stable two-pass sort by (key, value), then the
                     middle element(s) of each group's run.

Holistic aggregation cannot be computed from partials: a group's median
needs all of its values in one place, so it is a sort and a selection.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analytics import tracing
from repro_torch.analytics.columnar import (segment_median, segment_sum,
                                            stacked_group_sums)


# ---------------------------------------------------------------------------
# W2: distributive COUNT
# ---------------------------------------------------------------------------
def count_direct(keys: torch.Tensor, cardinality: int) -> torch.Tensor:
    """SELECT groupkey, COUNT(*) GROUP BY groupkey: (cardinality,) f32
    counts; keys outside [0, cardinality) are dropped."""
    with tracing.span("count_direct", "op"):
        return segment_sum(torch.ones_like(keys, dtype=torch.float32), keys,
                           cardinality)


def count_partitioned(keys: torch.Tensor, cardinality: int, *,
                      n_partitions: int = 64, capacity_factor: float = 2.0,
                      mode: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partitioned COUNT: range partitioning plus the hash_aggregate kernel.

    Range partitioning on dense group ids makes the partition-local slot
    (key % range) collision-free, so the result is exact whenever no
    partition overflows its capacity; the overflow is returned, never
    dropped silently. A COUNT is a fused sweep over one all-ones column.
    Returns ((cardinality,) f32 counts, int32 overflow). Its phases are
    the partitioned layout's spans (``columnar._fused_partitioned``)."""
    with tracing.span("count_partitioned", "op"):
        clipped = torch.clamp(keys, 0, cardinality - 1).to(torch.int32)
        ones = torch.ones(keys.shape + (1,), dtype=torch.float32,
                          device=keys.device)
        sums, overflow = stacked_group_sums(
            clipped, ones, cardinality, layout="partitioned", mode=mode,
            n_partitions=n_partitions, capacity_factor=capacity_factor)
        return sums[:, 0], overflow


# ---------------------------------------------------------------------------
# W1: holistic MEDIAN
# ---------------------------------------------------------------------------
def median_direct(keys: torch.Tensor, vals: torch.Tensor,
                  cardinality: int) -> torch.Tensor:
    """SELECT groupkey, MEDIAN(val) GROUP BY groupkey; keys in [0,
    cardinality). Empty groups give NaN.

    The reference takes each run's start as an f32 cumsum of f32 counts,
    exact only below 2^24 rows; here counts and starts are int64
    (``columnar._segment_selection``), so the two agree wherever the
    reference is exact and the port stays exact past it. Its phases are
    the selection's spans (``columnar.segment_median``)."""
    with tracing.span("median_direct", "op"):
        return segment_median(keys, vals.to(torch.float32), cardinality)[0]


# The reference jits median_direct under this name; the port runs eagerly.
median_jit = median_direct
