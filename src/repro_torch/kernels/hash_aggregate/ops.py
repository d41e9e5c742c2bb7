"""Fused partitioned aggregation with mode dispatch.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/hash_aggregate.cu``) or raises; on a CPU tensor it runs the plain
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
from repro_torch.kernels.hash_aggregate.ref import hash_aggregate_multi_ref

MAX_C = 8                 # columns one launch takes; wider inputs are split
WARPS = 8                 # warps (and tables) of a block with private tables
OWNED_THREADS = 512       # threads of a block with one shared table
STAGE = 1024              # rows a block stages per batch
STAGES = 3                # batches staged at once (in flight or in use)
BLOCK_SMEM = 232_448      # shared memory a block may take on an H100
SM_SMEM = 233_472         # shared memory of one H100 SM (1 KB of it is
                          # reserved for each resident block)
SM_THREADS = 2048         # threads an H100 SM holds
PRIVATE_FLOATS = 8_192    # warps' own tables, all 8 together (32 KB), at most
MIN_CHUNK_ROWS = 4096     # fewest rows worth a block of its own


def smem_bytes(tile_bins: int, C: int, private: bool) -> int:
    """Dynamic shared memory of one pass-1 block: its table(s), rounded
    up to 16 bytes, STAGES staged batches of ids and values, and with one
    wide table two bitmaps over its bins."""
    tables = -(-(WARPS if private else 1) * tile_bins * C // 4) * 4
    return 4 * (tables + STAGES * STAGE * (1 + C)
                + (0 if private else 2 * -(-tile_bins // 32)))


def launch_plan(P: int, T: int, C: int, n_bins: int,
                n_sms: int) -> Tuple[int, int, int, bool]:
    """(tile_bins, n_chunks, rows_per_chunk, private) for the CUDA kernel.

    Small tables (8 copies within PRIVATE_FLOATS) are kept per warp;
    larger ones are one table per block, as wide as shared memory allows
    beside the staging, and cut into bin tiles only beyond that. Rows are
    cut into chunks so the grid fills the SMs in one wave at the blocks an
    SM holds, never below MIN_CHUNK_ROWS rows a chunk. The sums' order
    follows from this plan and the data alone."""
    private = WARPS * n_bins * C <= PRIVATE_FLOATS
    if private:
        tile_bins = n_bins
    else:
        room = (BLOCK_SMEM - smem_bytes(0, C, False)) // 4 - 8
        tile_bins = max(1, min(n_bins, room * 16 // (16 * C + 1)))
    n_tiles = -(-n_bins // tile_bins)
    threads = 32 * WARPS if private else OWNED_THREADS
    per_sm = max(1, min(SM_THREADS // threads,
                        SM_SMEM // (smem_bytes(tile_bins, C, private)
                                    + 1024)))
    want = max(1, per_sm * n_sms // (P * n_tiles))
    n_chunks = max(1, min(want, -(-T // MIN_CHUNK_ROWS)))
    rows_per_chunk = -(-T // n_chunks)
    n_chunks = -(-T // rows_per_chunk)
    return tile_bins, n_chunks, rows_per_chunk, private


@functools.cache
def _bind():
    """The C entry point with its argument types, bound once."""
    lib = build.library("hash_aggregate")
    fn = lib.hash_aggregate_multi_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
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
    if C > MAX_C:
        return torch.cat([_launch(ids, vals[..., c:c + MAX_C].contiguous(),
                                  n_bins=n_bins)
                          for c in range(0, C, MAX_C)], dim=2)
    out = torch.empty((P, n_bins, C), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    if T == 0:
        return out.zero_()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_bins, n_chunks, rows_per_chunk, private = launch_plan(
        P, T, C, n_bins, n_sms)
    partial = (torch.empty((P, n_chunks, n_bins, C), dtype=torch.float32,
                           device=dev) if n_chunks > 1 else out)
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                partial.data_ptr(), P, T, C, n_bins, tile_bins, n_chunks,
                rows_per_chunk, int(private), stream_handle(dev))
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
    are the same bits from run to run (no float atomics): their order
    follows from the data and ``launch_plan`` alone."""
    if kernel_mode(mode, ids.device) == "cuda":
        return _launch(ids, vals, n_bins=n_bins)
    return hash_aggregate_multi_ref(ids, vals, n_bins=n_bins)


def hash_aggregate(ids: torch.Tensor, vals: torch.Tensor, *, n_bins: int,
                   mode: Optional[str] = None) -> torch.Tensor:
    """Partition-local segment sums. ids, vals: (P, T) -> (P, n_bins) f32.

    Thin single-aggregate wrapper over :func:`hash_aggregate_multi` (one
    launch of its kernel with C = 1 on a CUDA tensor)."""
    return hash_aggregate_multi(ids, vals[..., None], n_bins=n_bins,
                                mode=mode)[..., 0]
