"""Radix index probe with mode dispatch.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/radix_probe.cu``: a bounded lower bound per probe key in
registers, the top levels of every bucket's search staged in shared
memory) or raises; on a CPU tensor it runs the plain version (``ref.py``).
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_input, count_launch,
                                        kernel_mode, stream_handle)
from repro_torch.kernels.radix_probe.ref import radix_probe_ref


def _bind():
    lib = build.library("radix_probe")
    fn = lib.radix_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    return fn


def _launch(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor,
            bucket_starts: torch.Tensor, bits: int, probe_keys: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: sorted keys/vals (n,) int32/f32, bucket
    starts (2^bits + 1,) int64, probe keys (m,) int32, all contiguous on
    one CUDA device. Checks shapes alone: no read of a device value."""
    dev = probe_keys.device
    n, m = sorted_keys.shape[0], probe_keys.shape[0]
    if not 0 <= bits <= 30:
        raise ValueError(f"radix_probe takes 0 <= bits <= 30, got {bits}")
    check_input(sorted_keys, "sorted_keys", torch.int32, (n,), dev)
    check_input(sorted_vals, "sorted_vals", torch.float32, (n,), dev)
    check_input(bucket_starts, "bucket_starts", torch.int64,
                ((1 << bits) + 1,), dev)
    check_input(probe_keys, "probe_keys", torch.int32, (m,), dev)
    if n >= 1 << 31:
        raise ValueError("radix_probe takes fewer than 2^31 index keys")
    vals = torch.empty((m,), dtype=torch.float32, device=dev)
    found = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return vals, found
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(sorted_keys.data_ptr(), sorted_vals.data_ptr(),
                bucket_starts.data_ptr(), probe_keys.data_ptr(),
                vals.data_ptr(), found.data_ptr(), m, bits,
                stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"radix_probe launch failed: CUDA error {rc}")
    count_launch("radix_probe")
    return vals, found


def radix_probe(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor,
                bucket_starts: torch.Tensor, bits: int,
                probe_keys: torch.Tensor, *, mode: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe a radix index (``analytics.join.build_radix_index``'s fields)
    -> (vals f32, found bool), one each a probe key: the value at the
    key's first occurrence in its bucket's run (0.0 where there is none)
    and whether it occurs there. The kernel and the plain version give
    the same bits."""
    if kernel_mode(mode, probe_keys.device) == "cuda":
        return _launch(sorted_keys, sorted_vals, bucket_starts, bits,
                       probe_keys)
    return radix_probe_ref(sorted_keys, sorted_vals, bucket_starts, bits,
                           probe_keys)
