"""Fused partitioned aggregation with mode dispatch.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/hash_aggregate.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_input, count_launch,
                                        kernel_mode, stream_handle)
from repro_torch.kernels.hash_aggregate.ref import hash_aggregate_multi_ref

TABLE_FLOATS = 24_576     # shared-memory table budget of one block (96 KB)
MIN_CHUNK_ROWS = 4096     # fewest rows worth a block of its own
BLOCKS_PER_SM = 4         # blocks the chunking aims to give every SM


def launch_plan(P: int, T: int, C: int, n_bins: int,
                n_sms: int) -> Tuple[int, int, int]:
    """(tile_bins, n_chunks, rows_per_chunk) for the CUDA kernel.

    A block's (tile_bins x C) table lives in shared memory, so wide tables
    are cut into bin tiles; rows are cut into chunks until the grid gives
    every SM about BLOCKS_PER_SM blocks, never below MIN_CHUNK_ROWS rows."""
    tile_bins = max(1, min(n_bins, TABLE_FLOATS // C))
    n_tiles = -(-n_bins // tile_bins)
    want = -(-BLOCKS_PER_SM * n_sms // (P * n_tiles))
    n_chunks = max(1, min(want, -(-T // MIN_CHUNK_ROWS)))
    rows_per_chunk = -(-T // n_chunks)
    n_chunks = -(-T // rows_per_chunk)
    return tile_bins, n_chunks, rows_per_chunk


def _bind():
    lib = build.library("hash_aggregate")
    fn = lib.hash_aggregate_multi_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_void_p])
    return fn


def _launch(ids: torch.Tensor, vals: torch.Tensor, *,
            n_bins: int) -> torch.Tensor:
    """Launch the CUDA kernel: ids (P, T) int32, vals (P, T, C) f32, both
    contiguous on one CUDA device. Returns (P, n_bins, C) f32."""
    dev = ids.device
    P, T = ids.shape
    C = vals.shape[2] if vals.dim() == 3 else -1
    check_input(ids, "ids", torch.int32, (P, T), dev)
    check_input(vals, "vals", torch.float32, (P, T, C), dev)
    if n_bins < 1 or C < 1:
        raise ValueError(f"need n_bins >= 1 and C >= 1, got {n_bins}, {C}")
    out = torch.empty((P, n_bins, C), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    if T == 0:
        return out.zero_()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_bins, n_chunks, rows_per_chunk = launch_plan(P, T, C, n_bins, n_sms)
    partial = (torch.empty((P, n_chunks, n_bins, C), dtype=torch.float32,
                           device=dev) if n_chunks > 1 else out)
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                partial.data_ptr(), P, T, C, n_bins, tile_bins, n_chunks,
                rows_per_chunk, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"hash_aggregate_multi launch failed: CUDA error "
                           f"{rc}")
    count_launch("hash_aggregate_multi")
    return out


def hash_aggregate_multi(ids: torch.Tensor, vals: torch.Tensor, *,
                         n_bins: int,
                         mode: Optional[str] = None) -> torch.Tensor:
    """Fused partition-local segment sums over C stacked measure columns.

    ids: (P, T); vals: (P, T, C) -> (P, n_bins, C) f32. The kernel's sums
    are the same bits from run to run (no float atomics)."""
    if kernel_mode(mode, ids.device) == "cuda":
        return _launch(ids, vals, n_bins=n_bins)
    return hash_aggregate_multi_ref(ids, vals, n_bins=n_bins)
