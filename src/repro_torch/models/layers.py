"""Shared layer primitives: norms, activations, RoPE.

The counterpart of ``repro.models.layers``. Every reduction that decides
stability (the norm's mean of squares) is computed in float32 and cast
back to the input's dtype, as in the reference. ``apply_mrope`` and
``cross_entropy`` come with the slices that need them (the vlm family and
training).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def head_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (qwen3): normalize the trailing head_dim."""
    return rms_norm(x, weight, eps)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # the reference's gelu is jax.nn.gelu(approximate=True), the tanh form
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "relu": F.relu,
    "relu2": lambda x: F.relu(x).square(),
}


def activation(name: str):
    return _ACTIVATIONS[name]


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated FFN used by every assigned dense architecture."""
    f = activation(act)
    return (f(x @ w_gate) * (x @ w_up)) @ w_down


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotate-half RoPE convention (fp32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * inv_freq      # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
