"""Plain PyTorch version of the radix-histogram pass of partitioning.

``block_histograms_ref(keys, n_bins, shift, block)`` counts, per block of
``block`` keys, the radix digit ``(keys >>> shift) & (n_bins - 1)``. The
shift is logical, as in the reference: PyTorch's ``>>`` on int32 is
arithmetic (``-1 >> 8 == -1``), so the key's uint32 bit pattern is taken
in int64 first, where the two shifts agree.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def radix_digits(keys: torch.Tensor, n_bins: int, shift: int) -> torch.Tensor:
    """(keys >>> shift) & (n_bins - 1) as int64, with a logical shift."""
    return ((keys.to(torch.int64) & _MASK32) >> shift) & (n_bins - 1)


def block_histograms_ref(keys: torch.Tensor, *, n_bins: int, shift: int,
                         block: int) -> torch.Tensor:
    """keys: (N,) int32, N % block == 0. Returns (N // block, n_bins) int32
    histograms of the radix digit per block."""
    if keys.shape[0] % block:
        raise ValueError(f"N={keys.shape[0]} not divisible by block={block}")
    blocks = radix_digits(keys, n_bins, shift).reshape(-1, block)
    n_blocks = blocks.shape[0]
    base = torch.arange(n_blocks, device=keys.device)[:, None] * n_bins
    counts = torch.bincount((base + blocks).reshape(-1),
                            minlength=n_blocks * n_bins)
    return counts.reshape(n_blocks, n_bins).to(torch.int32)
