"""Plain PyTorch versions of the linear recurrence h_t = a_t h_{t-1} + b_t.

``linear_scan_sequential`` steps along time, one multiply-add per step:
the CPU path of ``linear_scan`` and the yardstick the CUDA kernel is held
to. ``linear_scan_doubling`` is a second, independent oracle for the
tests: the Hillis-Steele doubling scan over the associative combine
(a2, b2) o (a1, b1) = (a1 a2, b1 a2 + b2), the formulation of the
reference's ``linear_scan_ref`` and of its TPU kernel's inner scan.
Both compute in float32 with h_{-1} = 0 and return h of the shape of a.
"""
from __future__ import annotations

import torch


def linear_scan_sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D). Returns fp32 h, step by step along axis 1."""
    a, b = a.float(), b.float()
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def linear_scan_doubling(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D). Returns fp32 h by log2(S) doubling steps."""
    a, b = a.float().clone(), b.float().clone()
    shift, S = 1, a.shape[1]
    while shift < S:
        a_sh = torch.ones_like(a)
        b_sh = torch.zeros_like(b)
        a_sh[:, shift:] = a[:, :-shift]
        b_sh[:, shift:] = b[:, :-shift]
        b = b_sh * a + b
        a = a * a_sh
        shift *= 2
    return b
