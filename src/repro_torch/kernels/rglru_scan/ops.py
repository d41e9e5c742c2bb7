"""The linear-scan op of the RG-LRU block, with its backward.

On a CUDA tensor ``linear_scan`` launches the hand-written kernel
(``csrc/rglru_scan.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.linear_scan_sequential``). There is no fallback from one
to the other. The backward of h_t = a_t h_{t-1} + b_t is itself a linear
scan, run reversed, as in the reference:
  db_t = g_t + a_{t+1} db_{t+1}         (a suffix scan of the gradients)
  da_t = db_t * h_{t-1}
so it goes through the same dispatch: the CUDA kernel on the card.

The launch is the operator ``torch.ops.repro_torch.rglru_scan_fwd``
(``kernels.common``): a trace on fake tensors reaches its fake
implementation and its FLOP formula, ``flops``, and neither builds nor
launches. On DTensors (the sharded step) the scan runs on each rank's
block (``common.on_shards``) by ``RULE``: split over batch or width, the
time axis whole.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import (ShardRule, check_input,
                                        count_launch, is_sharded,
                                        kernel_mode, on_shards,
                                        stream_handle)
from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential

CHUNK = 32           # steps a warp's run covers before a carry enters
MAX_CHUNK = 96       # a block stages 2 x WARPS x chunk rows of 128 bytes
WARPS = 8            # runs a block: the kernel's kWarps


@functools.cache
def _bind():
    """The C entry point with its argument types, bound once."""
    fn = build.library("rglru_scan").rglru_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def flops(shape) -> int:
    """The recurrence's operations: a multiply and an add an element of
    (B, S, D), as the bound of PERF.md's kernel table counts them."""
    B, S, D = shape
    return 2 * B * S * D


# The launch as an operator of the ``repro_torch`` library: its CUDA
# implementation launches and counts; its fake implementation (a trace on
# fake tensors) gives h's shape and dtype with no build and no launch;
# ``flops`` is its formula for ``FlopCounterMode``. ``words`` is the
# chain's scratch, allocated by the wrapper so that a trace sees it.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("rglru_scan_fwd(Tensor a, Tensor b, Tensor(a!) words, "
            "int chunk) -> Tensor")


def _cuda_fwd(a, b, words, chunk):
    B, S, D = a.shape
    dev = a.device
    out = torch.empty_like(a)
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), None,
                words.data_ptr(), B, S, D, chunk, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {rc}")
    count_launch("rglru_scan")
    return out


_LIB.impl("rglru_scan_fwd", _cuda_fwd, "CUDA")


@torch.library.register_fake("repro_torch::rglru_scan_fwd", lib=_LIB)
def _fake_fwd(a, b, words, chunk):
    return torch.empty_like(a)


@register_flop_formula(torch.ops.repro_torch.rglru_scan_fwd)
def _fwd_flops(a_shape, b_shape, words_shape, chunk, out_shape=None,
               **kwargs) -> int:
    return flops(a_shape)


# a, b -> h, each (B, S, D)
RULE = ShardRule("rglru_scan", {"batch": (0, 0), "width": (2, 2)},
                 {"batch": (0,), "width": (2,)})


def _launch(a: torch.Tensor, b: torch.Tensor, *,
            chunk: int = CHUNK) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous float32 a, b (B, S, D) on one
    CUDA device, runs of ``chunk`` steps (``tests/_scan_order.py`` gives
    its bits). Returns h (B, S, D) float32."""
    dev = a.device
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, D), got {tuple(a.shape)}")
    B, S, D = a.shape
    check_input(a, "a", torch.float32, (B, S, D), dev)
    check_input(b, "b", torch.float32, (B, S, D), dev)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if a.numel() == 0:
        return torch.empty_like(a)
    # the chain's words (B, chunks, D), then the ticket; the launcher zeroes
    # them on the stream before the kernel
    nc = -(-S // (WARPS * chunk))
    words = torch.empty(B * nc * D + 1, dtype=torch.int64, device=dev)
    return torch.ops.repro_torch.rglru_scan_fwd(a, b, words, int(chunk))


def _dispatch(a: torch.Tensor, b: torch.Tensor,
              mode: Optional[str]) -> torch.Tensor:
    if kernel_mode(mode, a.device) == "cuda":
        return _launch(a.float().contiguous(), b.float().contiguous())
    return linear_scan_sequential(a, b)


class _LinearScan(torch.autograd.Function):
    """The dispatched scan; its backward is the same scan reversed."""

    @staticmethod
    def forward(ctx, a, b, mode):
        h = _dispatch(a, b, mode)
        ctx.save_for_backward(a, h)
        ctx.mode, ctx.b_dtype = mode, b.dtype
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        af = a.float()
        # the suffix scan db_t = g_t + a_{t+1} db_{t+1}, as a prefix scan
        # of the flipped sequences
        a_next = torch.cat([af[:, 1:], torch.zeros_like(af[:, :1])], dim=1)
        db = _dispatch(a_next.flip(1), g.float().flip(1), ctx.mode).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        da = db * h_prev
        return da.to(a.dtype), db.to(ctx.b_dtype), None


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                mode: Optional[str] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1, h_{-1} = 0. a, b:
    (B, S, D) -> float32 h."""
    if is_sharded(a, b):
        return on_shards(_LinearScan.apply, RULE, (a, b), (mode,))
    return _LinearScan.apply(a, b, mode)
