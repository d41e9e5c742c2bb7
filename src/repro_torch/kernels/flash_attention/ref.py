"""Plain PyTorch versions of attention.

``attention_naive``    materializes the full score matrix: the ground truth
                       for small test shapes.
``attention_chunked``  exact online softmax over KV blocks, the same
                       function as the reference's ``attention_chunked``
                       (same blocks, same masking, same 1e-37 floor on the
                       denominator). The CPU path of ``flash_attention``
                       and the yardstick the CUDA kernel is held to.
``decode_attention_ref`` one query token against a ring or linear KV
                       buffer (plain PyTorch; the reference has no kernel
                       for it either).

Shapes: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); Hq = G * Hkv (GQA).
``q_offset`` is the absolute position of q[0]; ``window`` (if set) masks
keys older than ``window`` positions (local attention). Scores are summed
in float32 whatever the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _divisor_block(size: int, preferred: int) -> int:
    b = min(preferred, size)
    while size % b:
        b -= 1
    return b


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, scale: Optional[float] = None,
                      block_q: int = 512, block_k: int = 1024
                      ) -> torch.Tensor:
    """Exact online-softmax attention, O(block_q * block_k) live scores."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    bq = _divisor_block(Sq, block_q)
    bk = _divisor_block(Skv, block_k)
    nq, nk = Sq // bq, Skv // bk
    dev = q.device
    out = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    for qi in range(nq):
        qblk = q[:, qi * bq:(qi + 1) * bq].reshape(B, bq, Hkv, G, D)
        # the block is scaled in its own dtype, then summed in float32
        qf = (qblk * torch.tensor(scale, dtype=qblk.dtype)).float()
        qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, Hkv, G, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, bq, D), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kblk = k[:, ki * bk:(ki + 1) * bk].float()
            vblk = v[:, ki * bk:(ki + 1) * bk]
            kpos = ki * bk + torch.arange(bk, device=dev)
            msk = _mask(qpos, kpos, causal, window)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kblk)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            # fully-masked positions would otherwise contribute exp(0) = 1
            p = torch.where(msk, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(q.dtype).float(), vblk.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-37)[..., None]
        out[:, qi * bq:(qi + 1) * bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, Hq, D)
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor, *,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q (B, 1, Hq, D); k/v (B, Smax, Hkv, D) ring or
    linear buffer with ``cache_len`` (B,) valid entries, the new token
    already written."""
    B, _, Hq, D = q.shape
    _, Smax, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.float()) * scale
    tpos = torch.arange(Smax, device=q.device)
    valid = tpos[None, :] < cache_len[:, None]                # (B, Smax)
    if window is not None:
        valid &= tpos[None, :] > (cache_len[:, None] - 1 - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)
