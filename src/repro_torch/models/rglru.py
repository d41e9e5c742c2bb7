"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The counterpart of ``repro.models.rglru``. Block structure:
    y_branch = GeLU(W_y x)                          (tanh GeLU)
    r_branch = W_x x -> causal conv1d(width 4) -> RG-LRU -> h
    out      = W_o (y_branch * h)

RG-LRU recurrence (elementwise over d_rnn), with c = 8:
    r_t = sigmoid(w_a u_t + b_a),  i_t = sigmoid(w_i u_t + b_i)
    log_a_t = -c softplus(lam) r_t,  a_t = exp(log_a_t)
    h_t = a_t h_{t-1} + sqrt(max(1 - exp(2 log_a_t), 1e-9)) (i_t u_t)

The full-sequence pass runs the recurrence through ``linear_scan`` (the
CUDA kernel on the card); decode is one elementwise step on O(d_rnn)
state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig
from repro_torch.core.params import pdef
from repro_torch.kernels.rglru_scan import linear_scan
from repro_torch.models.layers import activation, shift_right

_C = 8.0


def rglru_schema(arch: ArchConfig) -> Dict[str, Any]:
    h = arch.hybrid
    d = arch.d_model
    dr = h.d_rnn or d
    return {
        "w_y": pdef((d, dr), ("embed", "d_rnn"), "scaled"),
        "w_x": pdef((d, dr), ("embed", "d_rnn"), "scaled"),
        "w_o": pdef((dr, d), ("d_rnn", "embed"), "scaled"),
        "conv_w": pdef((h.conv_width, dr), (None, "d_rnn"), "scaled", 0.1),
        "conv_b": pdef((dr,), ("d_rnn",), "zeros"),
        "w_a": pdef((dr,), ("d_rnn",), "scaled", 0.1),
        "b_a": pdef((dr,), ("d_rnn",), "zeros"),
        "w_i": pdef((dr,), ("d_rnn",), "scaled", 0.1),
        "b_i": pdef((dr,), ("d_rnn",), "zeros"),
        "lam": pdef((dr,), ("d_rnn",), "uniform", 1.0),
    }


def _gates(p, u):
    """u: (..., d_rnn) conv output. Returns (a, b) of the recurrence."""
    uf = u.float()
    r = torch.sigmoid(uf * p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(uf * p["w_i"].float() + p["b_i"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * uf)
    return a, b


def _causal_conv(p, x, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (B, S, dr). Returns (out, new_state);
    the new state is in x's dtype, as the reference returns it."""
    w = p["conv_w"].float()                      # (W, dr)
    W = w.shape[0]
    xf = x.float()
    if conv_state is not None:                   # decode: state (B, W-1, dr)
        ctx = torch.cat([conv_state.float(), xf], dim=1)
        out = (ctx * w[None]).sum(dim=1, keepdim=True)
        return ((out + p["conv_b"].float()).to(x.dtype),
                ctx[:, 1:].to(x.dtype))
    pad = shift_right(xf, W - 1)
    out = 0
    for i in range(W):                           # the reference's order
        out = out + pad[:, i:i + x.shape[1]] * w[i]
    return (out + p["conv_b"].float()).to(x.dtype), None


def rglru_forward(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig,
                  kernel_mode: Optional[str] = None) -> torch.Tensor:
    """Full-sequence pass. x: (B, S, d)."""
    y = activation("gelu")(x @ p["w_y"])
    u, _ = _causal_conv(p, x @ p["w_x"])
    a, b = _gates(p, u)
    h = linear_scan(a, b, mode=kernel_mode)      # (B, S, dr) fp32
    return (y * h.to(y.dtype)) @ p["w_o"]


def rglru_cache_spec(arch: ArchConfig, batch: int, dtype=torch.bfloat16
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)}: h stays float32, the conv state starts in
    the cache dtype."""
    h = arch.hybrid
    dr = h.d_rnn or arch.d_model
    return {"h": ((batch, dr), torch.float32),
            "conv": ((batch, h.conv_width - 1, dr), dtype)}


CACHE_AXES_RGLRU = {"h": ("batch", "d_rnn"),
                    "conv": ("batch", None, "d_rnn")}


def rglru_decode(p: Dict[str, Any], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], arch: ArchConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-step decode. x: (B, 1, d). Returns the output and the new state
    (new tensors: the conv state comes back in x's dtype, float32 after
    the first step even where the cache started in bfloat16)."""
    y = activation("gelu")(x @ p["w_y"])
    u, conv_state = _causal_conv(p, x @ p["w_x"], cache["conv"])
    a, b = _gates(p, u)                          # (B, 1, dr)
    h_new = a[:, 0] * cache["h"] + b[:, 0]
    out = (y * h_new[:, None].to(y.dtype)) @ p["w_o"]
    return out, {"h": h_new, "conv": conv_state}
