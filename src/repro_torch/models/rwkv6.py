"""RWKV6 "Finch" blocks (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, and channel mixing.

The counterpart of ``repro.models.rwkv6``. Time mixing (per layer):
    sx      = shift(x) - x                      (token shift delta)
    base    = x + sx * mu_x
    deltas  = tanh(base @ W1) @ W2              (5 x LoRA: per-channel mixes)
    x_z     = x + sx * (mu_z + delta_z)         for z in (w, k, v, r, g)
    w       = exp(-exp(w0 + tanh(x_w @ A) @ B)) data-dependent decay (0, 1)
    r, k, v = projections; g = SiLU gate
    y       = WKV6 scan over heads of size N    (kernels/rwkv6_scan)
    out     = (GroupNorm_head(y) * g) @ Wo

Channel mixing:
    x_k = x + sx * mu_ck ; x_r = x + sx * mu_cr
    out = sigmoid(x_r @ Wr) * (relu(x_k @ Wk)^2 @ Wv)

The full-sequence pass runs the scan through ``wkv6`` (the CUDA kernel on
the card); decode is one plain ``wkv6_step``. The decode state per layer
is the WKV state (B, H, N, N) in float32 and the last token of each mix
(B, d) for the shift, stored in the cache's dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig, RWKVConfig
from repro_torch.core.params import pdef
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_step
from repro_torch.models.layers import shift_right

_MIX_KINDS = ("w", "k", "v", "r", "g")


def rwkv_schema(arch: ArchConfig) -> Dict[str, Any]:
    r = arch.rwkv or RWKVConfig()
    d, dff = arch.d_model, arch.d_ff
    H = d // r.head_size
    s: Dict[str, Any] = {
        "mu_x": pdef((d,), ("embed",), "uniform", 0.5),
        "mix_w1": pdef((d, 5 * r.mix_lora), ("embed", "lora"), "scaled"),
        "mix_w2": pdef((5, r.mix_lora, d), (None, "lora", "embed"),
                       "scaled"),
        "decay_w0": pdef((d,), ("embed",), "uniform", 0.5),
        "decay_w1": pdef((d, r.decay_lora), ("embed", "lora"), "scaled"),
        "decay_w2": pdef((r.decay_lora, d), ("lora", "embed"), "scaled"),
        "bonus_u": pdef((H, r.head_size), ("rwkv_heads", "head_dim"),
                        "uniform", 0.5),
        "w_r": pdef((d, d), ("embed", "d_rnn"), "scaled"),
        "w_k": pdef((d, d), ("embed", "d_rnn"), "scaled"),
        "w_v": pdef((d, d), ("embed", "d_rnn"), "scaled"),
        "w_g": pdef((d, d), ("embed", "d_rnn"), "scaled"),
        "w_o": pdef((d, d), ("d_rnn", "embed"), "scaled"),
        "ln_x_scale": pdef((d,), ("embed",), "ones"),
        "ln_x_bias": pdef((d,), ("embed",), "zeros"),
        "cm_mu_k": pdef((d,), ("embed",), "uniform", 0.5),
        "cm_mu_r": pdef((d,), ("embed",), "uniform", 0.5),
        "cm_wk": pdef((d, dff), ("embed", "ff"), "scaled"),
        "cm_wv": pdef((dff, d), ("ff", "embed"), "scaled"),
        "cm_wr": pdef((d, d), ("embed", "d_rnn"), "scaled"),
    }
    for kind in _MIX_KINDS:
        s[f"mu_{kind}"] = pdef((d,), ("embed",), "uniform", 0.5)
    return s


def _heads(arch: ArchConfig) -> Tuple[int, int]:
    n = (arch.rwkv or RWKVConfig()).head_size
    return arch.d_model // n, n


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                n_heads: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the flattened (H * N) channel dim, in
    float32, with the population variance (``jnp.var``, correction 0)."""
    shp = y.shape
    yh = y.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).float()
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return yh.reshape(shp) * scale.float() + bias.float()


def _mixes(p: Dict[str, Any], x: torch.Tensor,
           sx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-dependent token-shift mixes for (w, k, v, r, g)."""
    base = x + sx * p["mu_x"]
    lora = torch.tanh(base @ p["mix_w1"])                 # (..., 5 * L)
    L = p["mix_w2"].shape[1]
    lora = lora.reshape(lora.shape[:-1] + (5, L))
    deltas = torch.einsum("...zl,zld->...zd", lora, p["mix_w2"])
    return {kind: x + sx * (p[f"mu_{kind}"] + deltas[..., i, :])
            for i, kind in enumerate(_MIX_KINDS)}


def _decay(p: Dict[str, Any], xw: torch.Tensor) -> torch.Tensor:
    """exp(-exp(clip(w0 + dd, -8, 8))) in float32: in (0, 1)."""
    dd = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    log_w = -torch.exp(torch.clamp(p["decay_w0"].float() + dd.float(),
                                   -8.0, 8.0))
    return torch.exp(log_w)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """shift(x) - x: the previous token (zero before the first) minus x."""
    return shift_right(x[:, :-1], 1) - x


def time_mix_forward(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig,
                     kernel_mode: Optional[str] = None) -> torch.Tensor:
    """Full-sequence time mixing. x: (B, S, d)."""
    B, S, d = x.shape
    H, N = _heads(arch)
    mixes = _mixes(p, x, _shift(x))
    w = _decay(p, mixes["w"]).reshape(B, S, H, N)
    r = (mixes["r"] @ p["w_r"]).reshape(B, S, H, N)
    k = (mixes["k"] @ p["w_k"]).reshape(B, S, H, N)
    v = (mixes["v"] @ p["w_v"]).reshape(B, S, H, N)
    g = F.silu(mixes["g"] @ p["w_g"])
    y, _ = wkv6(r, k, v, w, p["bonus_u"], mode=kernel_mode)
    y = _group_norm(y.reshape(B, S, d), p["ln_x_scale"], p["ln_x_bias"], H)
    return (y.to(x.dtype) * g) @ p["w_o"]


def _channel_mix(p: Dict[str, Any], x: torch.Tensor,
                 sx: torch.Tensor) -> torch.Tensor:
    xk = x + sx * p["cm_mu_k"]
    xr = x + sx * p["cm_mu_r"]
    h = F.relu(xk @ p["cm_wk"]).square() @ p["cm_wv"]
    return torch.sigmoid(xr @ p["cm_wr"]) * h


def channel_mix_forward(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    return _channel_mix(p, x, _shift(x))


def rwkv_cache_spec(arch: ArchConfig, batch: int, dtype=torch.bfloat16
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)}: the WKV state stays float32, the shift
    states are in the cache dtype."""
    H, N = _heads(arch)
    d = arch.d_model
    return {"wkv": ((batch, H, N, N), torch.float32),
            "shift_tm": ((batch, d), dtype),
            "shift_cm": ((batch, d), dtype)}


CACHE_AXES_RWKV = {
    "wkv": ("batch", "rwkv_heads", "head_dim", None),
    "shift_tm": ("batch", None),
    "shift_cm": ("batch", None),
}


def time_mix_decode(p: Dict[str, Any], x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], arch: ArchConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-step time mixing. x: (B, 1, d). The shift state is read back in
    x's dtype and stored in the cache's; the new entries are new tensors."""
    B, _, d = x.shape
    H, N = _heads(arch)
    xt = x[:, 0]
    sx = (cache["shift_tm"].to(xt.dtype) - xt)[:, None]
    mixes = _mixes(p, x, sx)
    w = _decay(p, mixes["w"]).reshape(B, H, N)
    r = (mixes["r"] @ p["w_r"]).reshape(B, H, N)
    k = (mixes["k"] @ p["w_k"]).reshape(B, H, N)
    v = (mixes["v"] @ p["w_v"]).reshape(B, H, N)
    g = F.silu(mixes["g"] @ p["w_g"])[:, 0]
    y, wkv_state = wkv6_step(r, k, v, w, p["bonus_u"], cache["wkv"])
    y = _group_norm(y.reshape(B, d), p["ln_x_scale"], p["ln_x_bias"], H)
    out = ((y.to(xt.dtype) * g) @ p["w_o"])[:, None]
    return out, dict(cache, wkv=wkv_state,
                     shift_tm=xt.to(cache["shift_tm"].dtype))


def channel_mix_decode(p: Dict[str, Any], x: torch.Tensor,
                       cache: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    xt = x[:, 0]
    sx = (cache["shift_cm"].to(xt.dtype) - xt)[:, None]
    out = _channel_mix(p, x, sx)
    return out, dict(cache, shift_cm=xt.to(cache["shift_cm"].dtype))
