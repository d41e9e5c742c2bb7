"""Radix-partition ops: the histogram pass (kernel) and a stable scatter
by digit composed into a partitioner.

On a CUDA tensor ``block_histograms`` launches the hand-written kernel
(``csrc/radix_partition.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_input, count_launch,
                                        kernel_mode, stream_handle)
from repro_torch.kernels.radix_partition.ref import (block_histograms_ref,
                                                     radix_digits)

MAX_BINS = 256            # the kernel's shared-memory histogram width


@functools.cache
def _bind():
    """The C entry point with its argument types, bound once."""
    lib = build.library("radix_partition")
    fn = lib.block_histograms_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(keys: torch.Tensor, *, n_bins: int, shift: int,
            block: int) -> torch.Tensor:
    """Launch the CUDA kernel on keys (N,) int32, contiguous on a CUDA
    device, N % block == 0. Returns (N // block, n_bins) int32."""
    dev = keys.device
    N = keys.shape[0] if keys.dim() == 1 else -1
    check_input(keys, "keys", torch.int32, (N,), dev)
    if block < 1 or N % block:
        raise ValueError(f"N={N} not divisible by block={block}")
    if not (1 <= n_bins <= MAX_BINS and n_bins & (n_bins - 1) == 0):
        raise ValueError(f"n_bins must be a power of two in [1, {MAX_BINS}],"
                         f" got {n_bins}")
    if not 0 <= shift < 32:
        raise ValueError(f"shift must be in [0, 32), got {shift}")
    n_blocks = N // block
    out = torch.empty((n_blocks, n_bins), dtype=torch.int32, device=dev)
    if n_blocks == 0:
        return out
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), out.data_ptr(), n_blocks, block, n_bins,
                shift, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"block_histograms launch failed: CUDA error {rc}")
    count_launch("block_histograms")
    return out


def block_histograms(keys: torch.Tensor, *, n_bins: int, shift: int = 0,
                     block: int = 1024,
                     mode: Optional[str] = None) -> torch.Tensor:
    """(N // block, n_bins) int32 counts per block of the radix digit
    ``(keys >>> shift) & (n_bins - 1)``; N must be a block multiple."""
    if kernel_mode(mode, keys.device) == "cuda":
        return _launch(keys, n_bins=n_bins, shift=shift, block=block)
    return block_histograms_ref(keys, n_bins=n_bins, shift=shift, block=block)


def padded_bin_counts(keys: torch.Tensor, *, n_bins: int, shift: int = 0,
                      block: int = 1024,
                      mode: Optional[str] = None) -> torch.Tensor:
    """Total per-digit counts (int32) via the block histograms, for any N.

    Keys are padded with zeros to a block multiple; padding lands in the
    digit-0 bin ((0 >>> shift) & mask == 0), so that bin's count is
    corrected before returning. N == 0 gives all-zero counts."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((n_bins,), dtype=torch.int32, device=keys.device)
    pad = -n % block
    padded = (torch.cat([keys, keys.new_zeros((pad,))]) if pad
              else keys.contiguous())
    hist = block_histograms(padded, n_bins=n_bins, shift=shift, block=block,
                            mode=mode)
    counts = hist.sum(dim=0, dtype=torch.int32)
    if pad:
        counts[0] -= pad
    return counts


def radix_partition(keys: torch.Tensor, values: torch.Tensor, *,
                    n_bins: int, shift: int = 0, block: int = 1024,
                    mode: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partition (keys, values) by radix digit.

    Returns (keys_out, values_out, bin_starts int32) with records stably
    grouped by digit: the histogram from the kernel, the scatter a stable
    sort on the digit."""
    digits = radix_digits(keys, n_bins, shift)
    counts = padded_bin_counts(keys, n_bins=n_bins, shift=shift, block=block,
                               mode=mode)
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    order = torch.argsort(digits, stable=True)
    return keys[order], values[order], starts
