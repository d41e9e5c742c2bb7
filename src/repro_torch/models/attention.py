"""Grouped-query attention: schema, full-sequence pass, KV cache, decode.

The counterpart of the GQA half of ``repro.models.attention``, RoPE and
M-RoPE (MLA comes with the deepseek slice). Head counts arrive TP-padded
(``core.config.PaddedDims``). The full-sequence pass goes through
``flash_attention`` (the CUDA kernel on the card); decode is plain.

KV cache: k/v buffers (B, Smax, KV, Dh) and the lengths (B,) that the
model keeps. ``gqa_decode`` writes the new entry into the buffers IN PLACE
(the reference returns new arrays) and returns them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.config import ArchConfig, PaddedDims, RopeKind
from repro_torch.core.params import pdef
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import decode_attention_ref
from repro_torch.models.layers import apply_mrope, apply_rope, head_rms_norm


def gqa_schema(arch: ArchConfig, padded: PaddedDims) -> Dict[str, Any]:
    d, hd = arch.d_model, arch.resolved_head_dim
    H, KV = padded.n_heads, padded.n_kv_heads
    s = {
        "wq": pdef((d, H, hd), ("embed", "heads", "head_dim"), "scaled"),
        "wk": pdef((d, KV, hd), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wv": pdef((d, KV, hd), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wo": pdef((H, hd, d), ("heads", "head_dim", "embed"), "scaled"),
    }
    if arch.qkv_bias:
        s["bq"] = pdef((H, hd), ("heads", "head_dim"), "zeros")
        s["bk"] = pdef((KV, hd), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = pdef((KV, hd), ("kv_heads", "head_dim"), "zeros")
    if arch.qk_norm:
        s["q_norm"] = pdef((hd,), ("head_dim",), "ones")
        s["k_norm"] = pdef((hd,), ("head_dim",), "ones")
    return s


def _project_qkv(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if arch.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if arch.qk_norm:
        q = head_rms_norm(q, p["q_norm"], arch.norm_eps)
        k = head_rms_norm(k, p["k_norm"], arch.norm_eps)
    return q, k, v


def _positions_rope(arch: ArchConfig, q, k, q_positions, k_positions):
    if arch.rope == RopeKind.ROPE:
        q = apply_rope(q, q_positions, arch.rope_theta)
        k = apply_rope(k, k_positions, arch.rope_theta)
    elif arch.rope == RopeKind.MROPE:
        q = apply_mrope(q, q_positions, arch.rope_theta)
        k = apply_mrope(k, k_positions, arch.rope_theta)
    return q, k


def gqa_forward(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig, *,
                positions: torch.Tensor, window: Optional[int] = None,
                kernel_mode: Optional[str] = None) -> torch.Tensor:
    """Full-sequence (prefill) GQA pass. x: (B, S, d); the causal mask
    takes the rows as contiguous positions from 0, ``positions`` ((S,), or
    (B, S, 3) for M-RoPE) only rotate q and k."""
    q, k, v = _project_qkv(p, x, arch)
    q, k = _positions_rope(arch, q, k, positions, positions)
    out = flash_attention(q, k, v, causal=True, window=window,
                          scale=arch.resolved_head_dim ** -0.5,
                          mode=kernel_mode)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def gqa_cache_spec(arch: ArchConfig, padded: PaddedDims, batch: int,
                   max_len: int, dtype=torch.bfloat16
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one layer's buffers."""
    shape = (batch, max_len, padded.n_kv_heads, arch.resolved_head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def gqa_init_cache(arch: ArchConfig, padded: PaddedDims, batch: int,
                   max_len: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    buf_len = min(max_len, arch.max_seq_len)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in gqa_cache_spec(
                arch, padded, batch, buf_len, dtype).items()}


def gqa_decode(p: Dict[str, Any], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
               arch: ArchConfig, *, window: Optional[int] = None,
               ring: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d); cache_len: (B,) absolute positions.

    Every lane writes at one shared slot, example 0's: ``cache_len[0] %
    buf`` in a ring buffer (local-attention layers, which hold the last
    ``buf`` tokens; keys are roped at absolute positions, so slot order is
    irrelevant), ``cache_len[0]`` in a linear one, clamped to the buffer's
    end as the reference's dynamic_update_slice clamps it. Serving waves
    are position-aligned, so one index serves every lane."""
    q, k, v = _project_qkv(p, x, arch)
    pos = cache_len[:, None]                       # (B, 1)
    if arch.rope == RopeKind.MROPE:                # the 3 streams share it
        pos = pos[..., None].expand(pos.shape + (3,))
    q, k = _positions_rope(arch, q, k, pos, pos)
    buf = cache["k"].shape[1]
    idx = cache_len[:1].long()
    idx = idx % buf if ring else idx.clamp(max=buf - 1)
    cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    scale = arch.resolved_head_dim ** -0.5
    if ring:
        valid = torch.clamp(cache_len + 1, max=buf)
        out = decode_attention_ref(q, cache["k"], cache["v"], valid,
                                   window=None, scale=scale)
    else:
        out = decode_attention_ref(q, cache["k"], cache["v"], cache_len + 1,
                                   window=window, scale=scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache
