"""Plain PyTorch version of the radix index probe.

The route the port took before the kernel, as the JAX reference takes it
(``repro.analytics.join.probe_radix_index``): a bucket lookup, then a
branchless binary search within the bucket's run, a fixed trip count of
``n.bit_length()`` steps, every probe key stepping at once.
"""
from __future__ import annotations

from typing import Tuple

import torch


def radix_probe_ref(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor,
                    bucket_starts: torch.Tensor, bits: int,
                    probe_keys: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (vals, found): each probe key's value at its first occurrence in
    its bucket's run of ``sorted_keys`` (0.0 where there is none), and
    whether it occurs there."""
    # imported here: the analytics package imports this one
    from repro_torch.analytics.hashing import multiply_shift
    bucket = multiply_shift(probe_keys, bits)
    lo = bucket_starts[bucket]
    hi = bucket_starts[bucket + 1]
    n = sorted_keys.shape[0]
    for _ in range(max(1, int(n).bit_length())):
        mid = (lo + hi) // 2
        go_right = sorted_keys[torch.clamp(mid, 0, n - 1)] < probe_keys
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right,
                                                                 hi, mid)
    pos = torch.clamp(lo, 0, n - 1)
    found = sorted_keys[pos] == probe_keys
    return torch.where(found, sorted_vals[pos], 0.0), found
