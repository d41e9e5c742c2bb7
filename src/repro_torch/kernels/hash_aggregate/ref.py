"""Plain PyTorch version of the fused partitioned aggregation.

ids[p, t] are partition-local group slots, vals[p, t, c] the measures
(1.0 for COUNT). Ids outside [0, n_bins) contribute nothing, as with
``jax.ops.segment_sum`` in the reference oracle: ``index_add_`` would raise
on them, so they are sent to a spare slot that is sliced off.
"""
from __future__ import annotations

import torch


def hash_aggregate_multi_ref(ids: torch.Tensor, vals: torch.Tensor, *,
                             n_bins: int) -> torch.Tensor:
    """ids: (P, T) int; vals: (P, T, C). Returns (P, n_bins, C) f32 sums."""
    P, T = ids.shape
    C = vals.shape[2]
    ok = (ids >= 0) & (ids < n_bins)
    base = torch.arange(P, device=ids.device, dtype=torch.int64)[:, None]
    flat = torch.where(ok, ids.to(torch.int64) + base * n_bins, P * n_bins)
    out = torch.zeros((P * n_bins + 1, C), dtype=torch.float32,
                      device=ids.device)
    out.index_add_(0, flat.reshape(-1),
                   vals.to(torch.float32).reshape(P * T, C))
    return out[:-1].reshape(P, n_bins, C)
