"""Attention op: the flash-attention forward (kernel) and its backward.

On a CUDA tensor ``flash_attention``'s forward launches the hand-written
kernel (``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs
the plain version (``ref.attention_chunked``). There is no fallback from
one to the other. The backward is the reference's: (out, lse) recomputed
with the plain ``ref.attention_chunked_with_lse``, then the blockwise
``ref.attention_chunked_bwd``, on every device. The reference has no
backward kernel either; its products go to the compiler, here to
``torch.matmul``. One-token decode has no kernel, in the reference or
here: it is the plain ``ref.decode_attention_ref`` on every device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_input, count_launch,
                                        kernel_mode, stream_handle)
from repro_torch.kernels.flash_attention.ref import (
    attention_chunked, attention_chunked_bwd, attention_chunked_with_lse)

HEAD_DIMS = (64, 128, 192, 256)   # the kernel's instantiations


@functools.cache
def _bind():
    """The C entry point with its argument types, bound once."""
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
    # the kernel reads q with float4 loads and copies k, v rows with bulk
    # copies, which need 16-byte aligned bases: a view off alignment is
    # copied to a fresh allocation
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Sq, Skv, Hq, Hkv, D, q_offset, int(causal),
                -1 if window is None else window, scale, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    count_launch("flash_attention")
    return out


def _dispatch(q, k, v, causal, window, q_offset, scale, mode):
    if kernel_mode(mode, q.device) == "cuda":
        return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=causal, window=window, q_offset=q_offset,
                       scale=scale)
    return attention_chunked(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)


class _Attention(torch.autograd.Function):
    """The dispatched forward; the reference's recompute-based backward
    (no residual but q, k, v: the memory stays flat in seq_len)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, mode):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = dict(causal=causal, window=window, q_offset=q_offset,
                       scale=scale)
        return _dispatch(q, k, v, causal, window, q_offset, scale, mode)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        out, lse = attention_chunked_with_lse(q, k, v, **ctx.cfg)
        dq, dk, dv = attention_chunked_bwd(q, k, v, out, lse, g, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Multi-head / grouped-query attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _Attention.apply(q, k, v, causal, window, q_offset, scale, mode)
