"""Attention blocks: GQA (RoPE and M-RoPE) and MLA (deepseek-v3).

The counterpart of ``repro.models.attention``. Each block owns its schema,
full-sequence pass, cache and decode. Head counts arrive TP-padded
(``core.config.PaddedDims``). The full-sequence passes go through
``flash_attention`` (the CUDA kernel on the card); decode is plain.

Caches (the lengths (B,) are the model's):
  GQA   k/v buffers (B, Smax, KV, Dh)
  MLA   the latent cache (B, Smax, kv_lora + rope_dim): decode runs the
        absorbed form (scores and mix in the latent space); the full-
        sequence pass expands per-head K/V and runs flash_attention at head
        dim qk_nope + qk_rope (192 for deepseek-v3), v zero-padded to it.
``gqa_decode`` and ``mla_decode`` write the new entry into the buffers IN
PLACE (the reference returns new arrays) and return them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.config import ArchConfig, PaddedDims, RopeKind
from repro_torch.core.params import pdef
from repro_torch.kernels.common import ShardRule, is_sharded, on_shards
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import decode_attention_ref
from repro_torch.models.layers import (apply_mrope, apply_rope,
                                       head_rms_norm, rms_norm)


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


CACHE_AXES_GQA = {
    "k": ("batch", "seq", "kv_heads", "head_dim"),
    "v": ("batch", "seq", "kv_heads", "head_dim"),
}


def _write_and_attend(q, k, v, cache_k, cache_v, cache_len, ring, window,
                      scale):
    """The new entry written into the buffers in place at lane 0's slot
    (``gqa_decode``), then one-token attention over them: (out, cache_k,
    cache_v)."""
    buf = cache_k.shape[1]
    idx = cache_len[:1].long()
    idx = idx % buf if ring else idx.clamp(max=buf - 1)
    cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v.to(cache_v.dtype))
    if ring:
        valid = torch.clamp(cache_len + 1, max=buf)
        out = decode_attention_ref(q, cache_k, cache_v, valid, window=None,
                                   scale=scale)
    else:
        out = decode_attention_ref(q, cache_k, cache_v, cache_len + 1,
                                   window=window, scale=scale)
    return out, cache_k, cache_v


# q, k, v (B, 1, H, D), the k and v buffers (B, Smax, KV, D), the lengths
# (B,) -> out, the two buffers: a rank's lanes and kv heads with their q
# heads (the cache's plan: batch over data, kv heads over model)
DECODE_RULE = ShardRule("decode_attention",
                        {"batch": (0, 0, 0, 0, 0, 0),
                         "heads": (2, 2, 2, 2, 2, None)},
                        {"batch": (0, 0, 0), "heads": (2, 2, 2)})


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
    scale = arch.resolved_head_dim ** -0.5
    args = (q, k, v, cache["k"], cache["v"], cache_len)
    if is_sharded(*args):
        # the rule's placements are the cache plan's, so each rank writes
        # into its own block of the buffers, in place as below
        out, _, _ = on_shards(_write_and_attend, DECODE_RULE, args,
                              (ring, window, scale))
    else:
        out, _, _ = _write_and_attend(*args, ring, window, scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------
def mla_schema(arch: ArchConfig, padded: PaddedDims) -> Dict[str, Any]:
    m = arch.mla
    d, H = arch.d_model, padded.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": pdef((d, m.q_lora_rank), ("embed", "q_lora"), "scaled"),
        "q_a_norm": pdef((m.q_lora_rank,), ("q_lora",), "ones"),
        "wq_b": pdef((m.q_lora_rank, H, qk_head),
                     ("q_lora", "heads", "head_dim"), "scaled"),
        "wkv_a": pdef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                      ("embed", "kv_lora"), "scaled"),
        "kv_a_norm": pdef((m.kv_lora_rank,), ("kv_lora",), "ones"),
        "wk_b": pdef((m.kv_lora_rank, H, m.qk_nope_head_dim),
                     ("kv_lora", "heads", "head_dim"), "scaled"),
        "wv_b": pdef((m.kv_lora_rank, H, m.v_head_dim),
                     ("kv_lora", "heads", "head_dim"), "scaled"),
        "wo": pdef((H, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                   "scaled"),
    }


def _mla_latent(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig):
    """The shared latent path: (c_kv normed (B, S, r), k_rope not yet
    roped (B, S, rope))."""
    m = arch.mla
    kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    return rms_norm(c_kv, p["kv_a_norm"], arch.norm_eps), k_rope


def _mla_queries(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig):
    """(q_nope (B, S, H, qk_nope), q_rope (B, S, H, rope))."""
    m = arch.mla
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_a_norm"],
                  arch.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def mla_forward(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig, *,
                positions: torch.Tensor,
                kernel_mode: Optional[str] = None) -> torch.Tensor:
    """Full-sequence (prefill / train) MLA: per-head K/V expanded from the
    latent. x: (B, S, d); positions (S,) rotate q_rope and the one shared
    k_rope head. flash_attention takes one head dim for q, k and v, so v
    is zero-padded from v_head_dim to qk_nope + qk_rope and the output
    sliced back: the zero columns mix to exact zeros."""
    m = arch.mla
    q_nope, q_rope = _mla_queries(p, x, arch)
    c_kv, k_rope = _mla_latent(p, x, arch)
    q_rope = apply_rope(q_rope, positions, arch.rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], positions, arch.rope_theta)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"])
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    args = (q_nope, q_rope, k_nope, k_rope, v)
    if is_sharded(*args):
        q, k, v_pad = on_shards(_mla_heads, MLA_HEADS_RULE, args, (qk_head,))
    else:
        q, k, v_pad = _mla_heads(*args, qk_head)
    out = flash_attention(q, k, v_pad, causal=True, scale=qk_head ** -0.5,
                          mode=kernel_mode)[..., :m.v_head_dim]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _mla_heads(q_nope, q_rope, k_nope, k_rope, v, width: int):
    """flash_attention's per-head (q, k, v) at head dim ``width``: the
    rope parts beside the nope ones, the one shared k_rope head (B, S, 1,
    rope) repeated over the heads there are, v zero-padded (by a
    concatenation: PyTorch 2.11's DTensor rule for ``F.pad`` breaks
    placements)."""
    H = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(-1, -1, H, -1)], dim=-1)
    pad = v.new_zeros(v.shape[:-1] + (width - v.shape[-1],))
    return q, k, torch.cat([v, pad], dim=-1)


# q_nope, q_rope, k_nope, k_rope (B, S, 1, rope), v -> q, k, v: a rank's
# lanes and heads, the shared k_rope head whole under the head split
MLA_HEADS_RULE = ShardRule("mla_heads",
                           {"batch": (0, 0, 0, 0, 0),
                            "heads": (2, 2, 2, None, 2)},
                           {"batch": (0, 0, 0), "heads": (2, 2, 2)})


def mla_cache_spec(arch: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one layer's latent cache."""
    m = arch.mla
    return {"latent": ((batch, max_len, m.kv_lora_rank + m.qk_rope_head_dim),
                       dtype)}


CACHE_AXES_MLA = {"latent": ("batch", "seq", "kv_lora")}


def mla_init_cache(arch: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in mla_cache_spec(
                arch, batch, max_len, dtype).items()}


def mla_decode(p: Dict[str, Any], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
               arch: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-MLA one-token decode: scores and mix in the kv_lora-wide
    latent space, no per-head K/V. x: (B, 1, d); cache_len: (B,).

    Per head h:  s = (q_nope[h] @ wk_b[:, h].T) . c_kv + q_rope . k_rope
                 out[h] = (softmax(s) @ c_kv) @ wv_b[:, h]
    The new [c_kv; roped k_rope] entry lands at lane 0's slot (clamped to
    the buffer's end), as in ``gqa_decode``. Scores, softmax and mix are
    float32 whatever the cache's dtype, as the reference's
    ``preferred_element_type``. On DTensors the write and the attention
    run on each rank's blocks (``MLA_DECODE_RULE``): its lanes, or its
    heads of ``wk_b``/``wv_b`` over the whole latent cache, which keeps
    the scores split by head as the reference's sharding hint does; the
    product with ``wo`` sums the heads' parts."""
    m = arch.mla
    r = m.kv_lora_rank
    q_nope, q_rope = _mla_queries(p, x, arch)        # (B, 1, H, *)
    c_new, kr_new = _mla_latent(p, x, arch)          # (B, 1, r), (B, 1, rope)
    pos = cache_len[:, None]
    q_rope = apply_rope(q_rope, pos, arch.rope_theta)
    kr_new = apply_rope(kr_new[..., None, :], pos, arch.rope_theta)[..., 0, :]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    args = (q_nope, q_rope, torch.cat([c_new, kr_new], dim=-1),
            cache["latent"], cache_len, p["wk_b"], p["wv_b"])
    if is_sharded(*args):
        # the rule's placements are the cache plan's: each rank writes
        # into its own block of the latent cache, in place as below
        out, _ = on_shards(_mla_attend, MLA_DECODE_RULE, args, (r, scale))
    else:
        out, _ = _mla_attend(*args, r, scale)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"].float())
    return y[:, None, :].to(x.dtype), cache


def _mla_attend(q_nope, q_rope, entry, latent, cache_len, wk_b, wv_b,
                r: int, scale: float):
    """The new latent ``entry`` written into the buffer in place at lane
    0's slot (clamped to its end), then the absorbed one-token attention
    over it: (out (B, H, v_head_dim) float32, the buffer)."""
    idx = cache_len[:1].long().clamp(max=latent.shape[1] - 1)
    latent.index_copy_(1, idx, entry.to(latent.dtype))
    c_kv = latent[..., :r].float()                   # (B, S, r)
    k_rope = latent[..., r:].float()                 # (B, S, rope)
    # wk_b absorbed into q: q_lat (B, H, r)
    q_lat = torch.einsum("bshk,rhk->bhr", q_nope, wk_b)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv)
         + torch.einsum("bshk,btk->bhst", q_rope.float(), k_rope)[:, :, 0]
         ) * scale
    tpos = torch.arange(latent.shape[1], device=latent.device)
    valid = tpos[None, :] < (cache_len + 1)[:, None]
    s = torch.where(valid[:, None, :], s, -1e30)
    attn = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bhs,bsr->bhr", attn, c_kv)
    return torch.einsum("bhr,rhk->bhk", out_lat, wv_b.float()), latent


# q_nope, q_rope (B, 1, H, *), the new entry (B, 1, r + rope), the latent
# cache (B, Smax, r + rope), the lengths (B,), wk_b, wv_b (r, H, *) ->
# out (B, H, v_head_dim), the cache: a rank's lanes (the cache's plan:
# batch over data), or its heads with the whole latent cache
MLA_DECODE_RULE = ShardRule("mla_decode",
                            {"batch": (0, 0, 0, 0, 0, None, None),
                             "heads": (2, 2, None, None, None, 1, 1)},
                            {"batch": (0, 0), "heads": (1, None)})
