"""The part of ``repro.analytics.engine`` that the lowering needs.

The placement-policy backend itself (routing, collectives, the
distributed executor) is the next slice of the port; lowering a plan for
a shard count is pure shape arithmetic and needs only the slot budget.
"""
from __future__ import annotations

from repro_torch.analytics.physical import ceil128


def routing_capacity(n_rows: int, n_shards: int,
                     capacity_factor: float) -> int:
    """Per-destination slot budget for routing ``n_rows`` local records to
    ``n_shards`` owners: the balanced share times ``capacity_factor``,
    rounded up to a 128-row tile."""
    return ceil128(int(capacity_factor * n_rows / n_shards))
