"""Attention op: the flash-attention forward (kernel).

On a CUDA tensor ``flash_attention`` launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.attention_chunked``). There is no fallback from one to the
other. The forward is all this slice needs: the op raises if a gradient
is asked of it (the reference's backward, a chunked recompute, comes with
training). One-token decode has no kernel, in the reference or here: it is
the plain ``ref.decode_attention_ref`` on every device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_input, count_launch,
                                        kernel_mode, stream_handle)
from repro_torch.kernels.flash_attention.ref import attention_chunked

HEAD_DIMS = (64, 128, 256)        # the kernel's instantiations


def _bind():
    fn = build.library("flash_attention").flash_attention_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: Optional[int], q_offset: int,
            scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous float32 q (B, Sq, Hq, D) and
    k, v (B, Skv, Hkv, D) on one CUDA device. Returns o like q."""
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    check_input(q, "q", torch.float32, (B, Sq, Hq, D), dev)
    check_input(k, "k", torch.float32, (B, Skv, Hkv, D), dev)
    check_input(v, "v", torch.float32, (B, Skv, Hkv, D), dev)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Sq, Skv, Hq, Hkv, D, q_offset, int(causal),
                -1 if window is None else window, scale, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    count_launch("flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Multi-head / grouped-query attention forward.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward only in this port: "
                           "run it under torch.no_grad()")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if kernel_mode(mode, q.device) == "cuda":
        return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=causal, window=window, q_offset=q_offset,
                       scale=scale)
    return attention_chunked(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
