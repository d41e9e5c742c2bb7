"""Hashing and partition-layout utilities shared by the analytics operators.

The counterpart of ``repro.analytics.hashing`` with the same uint32
semantics. PyTorch's ``>>`` on int32 is an arithmetic shift and it has no
CPU shift for uint32, so the hash works in int64 on the low 32 bits: the
multiply is split in two 16-bit halves of the constant so that no product
leaves the int64 range, and every shift acts on a non-negative value,
where arithmetic and logical shifts agree.
"""
from __future__ import annotations

from typing import Tuple

import torch

_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF


def multiply_shift(keys: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """32-bit multiplicative hash of the keys' bit patterns; returns the
    uint32 value in an int64 tensor, high bits well-mixed."""
    k = keys.to(torch.int64) & _MASK32
    lo = k * (_KNUTH & 0xFFFF)
    hi = ((k * (_KNUTH >> 16)) & 0xFFFF) << 16
    h = (lo + hi) & _MASK32
    if bits < 32:
        h = h >> (32 - bits)
    return h


def partition_of(keys: torch.Tensor, n_partitions: int) -> torch.Tensor:
    """Partition id (int32) from the TOP radix bits of the hash."""
    bits = max(1, int(n_partitions - 1).bit_length())
    h = multiply_shift(keys, 32)
    return (h >> (32 - bits)).to(torch.int32) % n_partitions


def pad_partitions(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor,
                   starts: torch.Tensor, counts: torch.Tensor,
                   n_partitions: int, pad_t: int, *, pad_key: int = -1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense (P, padT) layout from partition-contiguous arrays.

    ``sorted_vals`` may carry trailing measure dims — (N,) or (N, C).
    Returns (keys (P, padT), vals (P, padT[, C]), overflow: total records
    beyond capacity). Padded slots carry ``pad_key`` and zero values."""
    dev = sorted_keys.device
    slot = torch.arange(pad_t, device=dev)
    idx = starts.to(torch.int64)[:, None] + slot[None, :]
    valid = slot[None, :] < torch.clamp(counts, max=pad_t)[:, None]
    idx = torch.clamp(idx, 0, sorted_keys.shape[0] - 1)
    keys = torch.where(valid, sorted_keys[idx],
                       torch.tensor(pad_key, dtype=sorted_keys.dtype,
                                    device=dev))
    vmask = valid.reshape(valid.shape + (1,) * (sorted_vals.dim() - 1))
    vals = torch.where(vmask, sorted_vals[idx],
                       torch.zeros((), dtype=sorted_vals.dtype, device=dev))
    overflow = torch.clamp(counts - pad_t, min=0).sum()
    return keys, vals, overflow
