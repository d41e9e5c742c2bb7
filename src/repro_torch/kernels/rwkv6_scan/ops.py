"""The WKV6 ops of the RWKV6 time mix, with the scan's backward.

On a CUDA tensor ``wkv6`` launches the hand-written kernel
(``csrc/rwkv6_scan.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.wkv6_ref``). There is no fallback from one to the other.
The backward is the reference's: ``wkv6_ref`` recomputed under autograd
and its vjp taken, for y and the final state, on every device. The
kernel gives ``wkv6_ref``'s bits, so the gradients are those of autograd
through ``wkv6_ref``. One decode step has no kernel, in the reference or
here: ``wkv6_step`` is the plain op on every device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_input, count_launch,
                                        kernel_mode, stream_handle)
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref, wkv6_step_ref

HEAD_SIZES = (16, 32, 64)         # the kernel's instantiations

wkv6_step = wkv6_step_ref


def _bind():
    fn = build.library("rwkv6_scan").wkv6_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    return fn


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
    return _WKV6.apply(r, k, v, w, u, mode)
