"""The WKV6 ops of the RWKV6 time mix, with the scan's backward.

On a CUDA tensor ``wkv6`` launches the hand-written kernel
(``csrc/rwkv6_scan.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.wkv6_ref``). There is no fallback from one to the other.
The backward is the reference's: ``wkv6_ref`` recomputed under autograd
and its vjp taken, for y and the final state, on every device. The
kernel gives ``wkv6_ref``'s bits, so the gradients are those of autograd
through ``wkv6_ref``. One decode step has no kernel, in the reference or
here: ``wkv6_step`` is the plain op on every device.

The launch is the operator ``torch.ops.repro_torch.wkv6_fwd``
(``kernels.common``): a trace on fake tensors reaches its fake
implementation and its FLOP formula, ``flops``, and neither builds nor
launches. On DTensors (the sharded step) the scan runs on each rank's
block (``common.on_shards``) by ``RULE``: split over batch, or over heads
with ``u``'s heads beside them; time and the head size whole.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import (ShardRule, check_input,
                                        count_launch, is_sharded,
                                        kernel_mode, on_shards,
                                        stream_handle)
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref, wkv6_step_ref

HEAD_SIZES = (16, 32, 64)         # the kernel's instantiations

wkv6_step = wkv6_step_ref


def _bind():
    fn = build.library("rwkv6_scan").wkv6_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    return fn


def flops(shape) -> int:
    """The recurrence's operations on r, k, v, w of ``shape`` (B, S, H,
    N): 5 N^2 + 5 N a (batch row, step, head), as the bound of PERF.md's
    kernel table counts them."""
    B, S, H, N = shape
    return B * S * H * (5 * N * N + 5 * N)


# The launch as an operator of the ``repro_torch`` library: its CUDA
# implementation launches and counts; its fake implementation (a trace on
# fake tensors) gives y's and the state's shapes and dtypes with no build
# and no launch; ``flops`` is its formula for ``FlopCounterMode``.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("wkv6_fwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u) "
            "-> (Tensor, Tensor)")


def _cuda_fwd(r, k, v, w, u):
    B, S, H, N = r.shape
    dev = r.device
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    s_out = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, s_out
    sb, ss, sh, _ = r.stride()
    fn = _bind()
    with torch.cuda.device(dev):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, S, H, N,
                sb, ss, sh, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {rc}")
    count_launch("wkv6")
    return y, s_out


_LIB.impl("wkv6_fwd", _cuda_fwd, "CUDA")


@torch.library.register_fake("repro_torch::wkv6_fwd", lib=_LIB)
def _fake_fwd(r, k, v, w, u):
    B, S, H, N = r.shape
    return (r.new_empty((B, S, H, N), dtype=torch.float32),
            r.new_empty((B, H, N, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv6_fwd)
def _fwd_flops(r_shape, *args, out_shape=None, **kwargs) -> int:
    return flops(r_shape)


# r, k, v, w (B, S, H, N) and u (H, N) -> y (B, S, H, N), state (B, H, N, N)
RULE = ShardRule("wkv6",
                 {"batch": (0, 0, 0, 0, None), "heads": (2, 2, 2, 2, 0)},
                 {"batch": (0, 0), "heads": (2, 1)})


def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on float32 r, k, v, w (B, S, H, N) that share
    their strides and are contiguous in N, and contiguous u (H, N), on one
    CUDA device. Returns y (B, S, H, N) and the final state (B, H, N, N),
    both float32."""
    dev = r.device
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, N), got {tuple(r.shape)}")
    B, S, H, N = r.shape
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_input(x, name, torch.float32, (B, S, H, N), dev,
                    contiguous=False)
        if x.stride()[:3] != r.stride()[:3]:
            raise ValueError(f"{name} has strides {x.stride()}, r has "
                             f"{r.stride()}: the kernel takes one set")
    check_input(u, "u", torch.float32, (H, N), dev)
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not in the kernel's {HEAD_SIZES}")
    return tuple(torch.ops.repro_torch.wkv6_fwd(r, k, v, w, u))


def _strided(xs):
    """r, k, v, w as float32 views the kernel reads in place when they
    share strides and are contiguous in N, else contiguous copies."""
    xs = [x.float() for x in xs]
    if all(x.stride() == xs[0].stride() for x in xs) and \
            xs[0].stride(-1) == 1:
        return xs
    return [x.contiguous() for x in xs]


def _dispatch(r, k, v, w, u, mode):
    if kernel_mode(mode, r.device) == "cuda":
        r, k, v, w = _strided((r, k, v, w))
        return _launch(r, k, v, w, u.float().contiguous())
    return wkv6_ref(r, k, v, w, u)


class _WKV6(torch.autograd.Function):
    """The dispatched scan; its backward differentiates ``wkv6_ref``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, mode):
        ctx.save_for_backward(r, k, v, w, u)
        return _dispatch(r, k, v, w, u, mode)

    @staticmethod
    def backward(ctx, gy, gs):
        ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            y, s = wkv6_ref(*ins)
        return (*torch.autograd.grad((y, s), ins, (gy, gs)), None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, mode: Optional[str] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 scan from a zero state. r, k, v, w: (B, S, H, N); u: (H, N).
    Returns (y (B, S, H, N) float32, the final state (B, H, N, N))."""
    if is_sharded(r, k, v, w, u):
        return on_shards(_WKV6.apply, RULE, (r, k, v, w, u), (mode,))
    return _WKV6.apply(r, k, v, w, u, mode)
