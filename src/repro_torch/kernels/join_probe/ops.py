"""Partition-wise join probe with mode dispatch.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/join_probe.cu``: a hash table per partition, built and probed in
two launches) or raises; on a CPU tensor it runs the plain version
(``ref.py``). There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import tracing
from repro_torch.kernels import build
from repro_torch.kernels.common import (check_input, count_launch,
                                        kernel_mode, stream_handle)
from repro_torch.kernels.join_probe.ref import join_probe_ref


# The build launch starts a key's walk at the top cap_log2 bits of
# mix32(uint32(key)), murmur3's finalizer (csrc/join_probe.cu, hash_slot),
# in a table of 2^cap_log2 >= 2 Bk entries per partition (table_log2).
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_U32 = 0xFFFFFFFF
_CHUNK = 256                # build slots a padding partial (the .cu kThreads)


def table_log2(Bk: int) -> int:
    """log2 of the per-partition table capacity for ``Bk`` build slots."""
    return max(6, (2 * Bk - 1).bit_length())


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer of h (int64 tensor of uint32 values)."""
    h = h ^ (h >> 16)
    h = (h * _M1) & _U32
    h = h ^ (h >> 13)
    h = (h * _M2) & _U32
    return h ^ (h >> 16)


def unmix32(h: torch.Tensor) -> torch.Tensor:
    """The inverse of mix32: the uint32 values that mix to h (int64)."""
    h = h ^ (h >> 16)
    h = (h * pow(_M2, -1, 1 << 32)) & _U32
    h = h ^ (h >> 13) ^ (h >> 26)
    h = (h * pow(_M1, -1, 1 << 32)) & _U32
    return h ^ (h >> 16)


def hash_slot(keys: torch.Tensor, cap_log2: int) -> torch.Tensor:
    """The table entry where the walk for each key starts, as the kernel
    computes it (int64 tensor)."""
    return mix32(keys.to(torch.int64) & _U32) >> (32 - cap_log2)


def _bind():
    lib = build.library("join_probe")
    fn = lib.join_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def _launch(build_keys: torch.Tensor, build_vals: torch.Tensor,
            probe_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: build keys/vals (P, Bk) int32/f32, probe
    keys (P, Pk) int32, all contiguous on one CUDA device. Raises
    ValueError when a partition holds a build key other than -1 twice
    (one host sync)."""
    dev = probe_keys.device
    P, Pk = probe_keys.shape
    Bk = build_keys.shape[1] if build_keys.dim() == 2 else -1
    check_input(build_keys, "build_keys", torch.int32, (P, Bk), dev)
    check_input(build_vals, "build_vals", torch.float32, (P, Bk), dev)
    check_input(probe_keys, "probe_keys", torch.int32, (P, Pk), dev)
    if max(P * Bk, P * Pk) >= 1 << 31:
        raise ValueError("join_probe takes fewer than 2^31 slots per side")
    vals = torch.empty((P, Pk), dtype=torch.float32, device=dev)
    found = torch.empty((P, Pk), dtype=torch.bool, device=dev)
    if P == 0 or Pk == 0:
        return vals, found
    cap_log2 = table_log2(Bk)
    n_chunks = max(1, -(-Bk // _CHUNK))
    table = torch.empty((P, 1 << cap_log2), dtype=torch.int64, device=dev)
    pad_sum = torch.empty((P, n_chunks), dtype=torch.float32, device=dev)
    pad_found = torch.empty((P, n_chunks), dtype=torch.int32, device=dev)
    duplicate = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(build_keys.data_ptr(), build_vals.data_ptr(),
                probe_keys.data_ptr(), vals.data_ptr(), found.data_ptr(),
                table.data_ptr(), pad_sum.data_ptr(), pad_found.data_ptr(),
                duplicate.data_ptr(), P, Bk, Pk, cap_log2,
                stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"join_probe launch failed: CUDA error {rc}")
    count_launch("join_probe")
    with tracing.span("sync:join_probe.duplicate", "sync"):
        duplicated = int(duplicate.item())
    if duplicated:
        raise ValueError("join_probe: a partition holds a build key other "
                         "than -1 twice; build keys must be unique (PK-FK)")
    return vals, found


def join_probe(build_keys: torch.Tensor, build_vals: torch.Tensor,
               probe_keys: torch.Tensor, *, mode: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PK-FK partition-local probe -> (matched vals (P,Pk), found (P,Pk)).

    Build keys other than -1 must be unique in their partition: the CUDA
    kernel raises ValueError on a duplicate, the plain version sums."""
    if kernel_mode(mode, probe_keys.device) == "cuda":
        return _launch(build_keys, build_vals, probe_keys)
    return join_probe_ref(build_keys, build_vals, probe_keys)
