"""Plain PyTorch version of the partition-wise join probe.

Build keys are unique (PK-FK); key -1 is the padding of both sides. The
reference oracle materialises the whole (P, Pk, Bk) equality cube, which
at SF1 is 5.6e11 entries, so this version walks the probe side in chunks
that bound the cube to ``max_elems`` entries. Matches are taken with a
select and a sum, never a product.
"""
from __future__ import annotations

from typing import Tuple

import torch


def join_probe_ref(build_keys: torch.Tensor, build_vals: torch.Tensor,
                   probe_keys: torch.Tensor, *, max_elems: int = 1 << 26
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """build_keys/vals: (P, Bk); probe_keys: (P, Pk).
    Returns (vals (P, Pk) f32, found (P, Pk) bool)."""
    P, Bk = build_keys.shape
    Pk = probe_keys.shape[1]
    dev = probe_keys.device
    bv = build_vals.to(torch.float32)[:, None, :]
    vals = torch.zeros((P, Pk), dtype=torch.float32, device=dev)
    found = torch.zeros((P, Pk), dtype=torch.bool, device=dev)
    step = max(1, max_elems // max(1, P * Bk))
    for s in range(0, Pk, step):
        eq = probe_keys[:, s:s + step, None] == build_keys[:, None, :]
        found[:, s:s + step] = eq.any(dim=-1)
        vals[:, s:s + step] = torch.where(eq, bv, 0.0).sum(dim=-1)
    return vals, found
