"""Plain PyTorch versions of attention.

``attention_naive``    materializes the full score matrix: the ground truth
                       for small test shapes.
``attention_chunked``  exact online softmax over KV blocks, the same
                       function as the reference's ``attention_chunked``
                       (same blocks, same masking, same 1e-37 floor on the
                       denominator). The CPU path of ``flash_attention``
                       and the yardstick the CUDA kernel is held to.
``attention_chunked_with_lse`` the same, with each row's logsumexp.
``attention_chunked_bwd`` the reference's manual flash backward: the
                       scores recomputed block by block from (q, k, v,
                       lse), dq / dk / dv summed over the blocks. With
                       ``attention_chunked_with_lse``, the backward of
                       ``flash_attention`` (plain code on every device, as
                       in the reference).
``decode_attention_ref`` one query token against a ring or linear KV
                       buffer (plain PyTorch; the reference has no kernel
                       for it either).

Shapes: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); Hq = G * Hkv (GQA).
``q_offset`` is the absolute position of q[0]; ``window`` (if set) masks
keys older than ``window`` positions (local attention). Scores are summed
in float32 whatever the input dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    return attention_chunked_with_lse(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        scale=scale, block_q=block_q, block_k=block_k)[0]


def attention_chunked_with_lse(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: Optional[int] = None,
                               q_offset: int = 0,
                               scale: Optional[float] = None,
                               block_q: int = 512, block_k: int = 1024
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_chunked`` and each row's logsumexp of its scaled scores
    (the statistics the manual backward needs). Returns (out like q, lse
    float32 (B, Sq, Hq))."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    bq = _divisor_block(Sq, block_q)
    bk = _divisor_block(Skv, block_k)
    nq, nk = Sq // bq, Skv // bk
    dev = q.device
    out = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev)
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
        lse[:, qi * bq:(qi + 1) * bq] = (
            m + torch.log(torch.clamp(l, min=1e-37))).permute(
                0, 3, 1, 2).reshape(B, bq, Hq)
    return out.to(q.dtype), lse


def attention_chunked_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          dout: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None,
                          block_q: int = 512, block_k: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The reference's manual flash backward: scores recomputed per
    (kv block, q block) pair from (q, k, lse), O(block_q x block_k)
    transients. An outer loop over kv blocks gives dk_j and dv_j, an inner
    loop over q blocks adds into dq. Fully-masked blocks contribute zeros,
    as in the reference. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    bq = _divisor_block(Sq, block_q)
    bk = _divisor_block(Skv, block_k)
    nq, nk = Sq // bq, Skv // bk
    dev = q.device
    qg = q.reshape(B, nq, bq, Hkv, G, D)
    dog = dout.reshape(B, nq, bq, Hkv, G, D)
    # b h g q: the layout of the scores' rows
    lseg = lse.float().reshape(B, nq, bq, Hkv, G).permute(1, 0, 3, 4, 2)
    # delta = rowsum(dout * out), O(S) statistics
    delta = torch.einsum("bnqhgd,bnqhgd->nbhgq", dog.float(),
                         out.reshape(B, nq, bq, Hkv, G, D).float())
    dq = torch.zeros((B, nq, bq, Hkv, G, D), dtype=torch.float32,
                     device=dev)
    dk = torch.empty((B, Skv, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.empty((B, Skv, Hkv, D), dtype=torch.float32, device=dev)
    for kj in range(nk):
        kblk = k[:, kj * bk:(kj + 1) * bk].float()
        vblk = v[:, kj * bk:(kj + 1) * bk].float()
        kpos = kj * bk + torch.arange(bk, device=dev)
        dk_j = torch.zeros((B, bk, Hkv, D), dtype=torch.float32, device=dev)
        dv_j = torch.zeros((B, bk, Hkv, D), dtype=torch.float32, device=dev)
        for qi in range(nq):
            qf = qg[:, qi].float()
            dof = dog[:, qi].float()
            qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kblk) * scale
            msk = _mask(qpos, kpos, causal, window)
            p = torch.where(msk, torch.exp(s - lseg[qi][..., None]), 0.0)
            # the probabilities and score grads enter the products in the
            # inputs' dtype, as the reference's casts do
            pc = p.to(q.dtype).float()
            dv_j = dv_j + torch.einsum("bhgqk,bqhgd->bkhd", pc, dof)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vblk)
            ds = p * (dp - delta[qi][..., None]) * scale
            dsc = ds.to(q.dtype).float()
            dq[:, qi] += torch.einsum("bhgqk,bkhd->bqhgd", dsc, kblk)
            dk_j = dk_j + torch.einsum("bhgqk,bqhgd->bkhd", dsc, qf)
        dk[:, kj * bk:(kj + 1) * bk] = dk_j
        dv[:, kj * bk:(kj + 1) * bk] = dv_j
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
