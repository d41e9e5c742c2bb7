"""Partition-wise join probe with mode dispatch.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/join_probe.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, check_input, kernel_mode,
                                        stream_handle)
from repro_torch.kernels.join_probe.ref import join_probe_ref


def _bind():
    lib = build.library("join_probe")
    fn = lib.join_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


def _launch(build_keys: torch.Tensor, build_vals: torch.Tensor,
            probe_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: build keys/vals (P, Bk) int32/f32, probe
    keys (P, Pk) int32, all contiguous on one CUDA device."""
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
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(build_keys.data_ptr(), build_vals.data_ptr(),
                probe_keys.data_ptr(), vals.data_ptr(), found.data_ptr(),
                P, Bk, Pk, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"join_probe launch failed: CUDA error {rc}")
    LAUNCHES["join_probe"] += 1
    return vals, found


def join_probe(build_keys: torch.Tensor, build_vals: torch.Tensor,
               probe_keys: torch.Tensor, *, mode: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PK-FK partition-local probe -> (matched vals (P,Pk), found (P,Pk))."""
    if kernel_mode(mode, probe_keys.device) == "cuda":
        return _launch(build_keys, build_vals, probe_keys)
    return join_probe_ref(build_keys, build_vals, probe_keys)
