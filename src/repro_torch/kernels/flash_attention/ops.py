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

The launch is the operator ``torch.ops.repro_torch.flash_attention_fwd``
(``kernels.common``): a trace on fake tensors reaches its fake
implementation and its FLOP formula, ``flops``, and neither builds nor
launches. The kernel computes in float32: on its route ``_Attention``
hands it float32 copies of inputs of other dtypes (bfloat16 parameters),
and recomputes the backward from the same copies.

On DTensors (the sharded step) the attention runs on each rank's block
(``common.on_shards``) by ``RULE``: split over batch, or over q heads and
kv heads along the same mesh axis (``PaddedDims.for_tp`` keeps whole q:kv
groups on a block); sequence and head dim whole.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import (ShardRule, check_input,
                                        count_launch, is_sharded,
                                        kernel_mode, on_shards,
                                        stream_handle)
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


def visible_pairs(Sq: int, Skv: int, q_offset: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the causal and window masks leave visible, per
    (batch, query head): query i sits at q_offset + i, sees keys at or
    before it when causal and after it - window when windowed. Counted
    in numpy, so that a trace on fake tensors can call it."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(Sq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flops(q_shape, k_shape, causal: bool, window: Optional[int],
          q_offset: int) -> int:
    """The kernel's operations: 4 D a visible (query, key) pair of every
    batch row and query head (2 D for the score, 2 D for the mix), as the
    bound of PERF.md's kernel table counts them."""
    B, Sq, Hq, D = q_shape
    return 4 * D * B * Hq * visible_pairs(Sq, k_shape[1], q_offset, causal,
                                          window)


# The launch as an operator of the ``repro_torch`` library: its CUDA
# implementation launches and counts; its fake implementation (a trace on
# fake tensors) gives the output's shape and dtype with no build and no
# launch; ``flops`` is its formula for ``FlopCounterMode``. A window of -1
# is none.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, int q_offset, float scale) -> Tensor")


def _cuda_fwd(q, k, v, causal, window, q_offset, scale):
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
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
                Sq, Skv, Hq, Hkv, D, q_offset, int(causal), window, scale,
                stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    count_launch("flash_attention")
    return out


_LIB.impl("flash_attention_fwd", _cuda_fwd, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd", lib=_LIB)
def _fake_fwd(q, k, v, causal, window, q_offset, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, window, q_offset, scale,
               out_shape=None, **kwargs) -> int:
    return flops(q_shape, k_shape, causal, None if window < 0 else window,
                 q_offset)


# q, k, v -> out, each (B, S, H, D)
RULE = ShardRule("flash_attention",
                 {"batch": (0, 0, 0), "heads": (2, 2, 2)},
                 {"batch": (0,), "heads": (2,)})


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
    return torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, bool(causal), -1 if window is None else int(window),
        int(q_offset), float(scale))


class _Attention(torch.autograd.Function):
    """The dispatched forward; the reference's recompute-based backward
    (no residual but q, k, v: the memory stays flat in seq_len). On the
    kernel's route q, k, v are float32, the kernel's one dtype (copies of
    other dtypes), in the forward and in the backward's recompute alike;
    the output and the gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, mode):
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.cfg = dict(causal=causal, window=window, q_offset=q_offset,
                       scale=scale)
        if kernel_mode(mode, q.device) == "cuda":
            q, k, v = q.float(), k.float(), v.float()   # float32: as given
            out = _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                          **ctx.cfg)
        else:
            out = attention_chunked(q, k, v, **ctx.cfg)
        ctx.save_for_backward(q, k, v)
        return out.to(ctx.dtypes[0])

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        out, lse = attention_chunked_with_lse(q, k, v, **ctx.cfg)
        grads = attention_chunked_bwd(q, k, v, out, lse, g.to(q.dtype),
                                      **ctx.cfg)
        dq, dk, dv = (d.to(t) for d, t in zip(grads, ctx.dtypes))
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Multi-head / grouped-query attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if is_sharded(q, k, v):
        return on_shards(_Attention.apply, RULE, (q, k, v),
                         (causal, window, q_offset, scale, mode))
    return _Attention.apply(q, k, v, causal, window, q_offset, scale, mode)
