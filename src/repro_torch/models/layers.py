"""Shared layer primitives: norms, activations, RoPE / M-RoPE, the loss.

The counterpart of ``repro.models.layers``. Every reduction that decides
stability (the norm's mean of squares, the loss's logsumexp) is computed
in float32, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import is_sharded

NEG_INF = -1e9  # the reference's additive-mask value for padded vocab


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


def shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, S, ...) behind ``n`` zero steps along dim 1: F.pad's
    bits, by a concatenation with zeros, since not every PyTorch's DTensor
    has a sound rule for the pad."""
    zeros = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    return torch.cat([zeros, x], dim=1)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotate-half RoPE convention (fp32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of x (..., S, heads, hd) by angles (..., S, hd/2),
    in float32."""
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    return _rotate(x, positions.float()[..., None] * inv_freq)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int] = (1, 1, 2)) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): 3 position streams (t, h, w) rotate
    disjoint bands of the head dimension, of relative widths ``sections``.

    x: (..., seq, heads, head_dim); positions: (..., seq, 3)."""
    half = x.shape[-1] // 2
    total = sum(sections)
    widths = [half * s // total for s in sections]
    widths[-1] = half - sum(widths[:-1])
    stream = torch.cat([torch.full((w,), i, dtype=torch.long,
                                   device=x.device)
                        for i, w in enumerate(widths)])
    pos = positions.float()[..., stream]                  # (..., S, hd/2)
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    return _rotate(x, pos * inv_freq)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim in ATen's operations and
    order (the max, its infinities zeroed, the sum of exp(x - max), log,
    plus the max; the backward grad * exp(x - lse)), so its bits. On a
    DTensor split along that dim each rank reduces its block and the max
    and the sum reduce across ranks, where DTensor's own logsumexp gathers
    the whole dim first."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(-1, keepdim=True)
        m = torch.where(m.abs() == float("inf"), 0.0, m)
        out = (x - m).exp().sum(-1).log() + m.squeeze(-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - out.unsqueeze(-1)).exp()


def _split_pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's label column of a DTensor ``logits`` split along its
    last dim, on each rank's block: the entries whose vocab index (a rank's
    block of ``_vocab_index``) is the label, summed over the block, the
    rest zero, so the gather's bits; partial sums over the axes that split
    the vocab. Computed locally (``local_map``): DTensor's own rule for the
    mask may gather the whole vocab on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = logits.ndim - 1
    vocab = [p.is_shard(last) for p in logits.placements]
    rows = [p if p.is_shard() and not v else Replicate()
            for p, v in zip(logits.placements, vocab)]
    col_pl = [Shard(0) if v else Replicate() for v in vocab]
    out_pl = [Partial() if v else p for p, v in zip(rows, vocab)]

    def pick(x, col, ids):
        return torch.where(col == ids.unsqueeze(-1), x, 0.0).sum(-1)
    return local_map(pick, out_placements=out_pl,
                     in_placements=(list(logits.placements), col_pl, rows),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(
        logits, _vocab_index(logits), labels.long())


def _vocab_index(logits: torch.Tensor) -> torch.Tensor:
    """The column indices of ``logits``' last dim; on a DTensor split as
    that dim is, so that a mask built from them stays split."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    if not is_sharded(logits):
        return col
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    last = logits.ndim - 1
    return distribute_tensor(
        col, logits.device_mesh,
        [Shard(0) if p.is_shard(last) else Replicate()
         for p in logits.placements], src_data_rank=None)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, z_loss: float = 0.0,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE over a (possibly padded) vocab dimension.

    ``logits``: (..., V_padded); ``labels``: (...) ints < vocab_size.
    Padded vocab columns are masked before the float32 logsumexp. The
    label's logit is a gather where the reference contracts a one-hot:
    the same value, without another (..., V) float32 buffer (4.2 GB at
    4096 tokens of a 256,000 vocab). The logsumexp is ``_LogSumExp``. On
    DTensors (the sharded step, the vocab split over ranks) the label's
    logit is ``_split_pick``, its column picked by a mask and summed over
    the vocab, which gives the gather's bits (every other term is zero);
    both reduce across ranks without gathering the vocab.
    Returns (mean loss, mean z-term).
    """
    vpad = logits.shape[-1]
    logits = logits.float()
    if vpad != vocab_size:
        col = _vocab_index(logits)
        logits = torch.where(col < vocab_size, logits, NEG_INF)
    lse = _LogSumExp.apply(logits)
    if is_sharded(logits):
        label_logit = _split_pick(logits, labels)
    else:
        label_logit = logits.gather(-1,
                                    labels.long().unsqueeze(-1)).squeeze(-1)
    nll = lse - label_logit
    z = lse.square()
    if mask is not None:
        mask = mask.float()
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        zterm = (z * mask).sum() / denom
    else:
        loss = nll.mean()
        zterm = z.mean()
    return loss + z_loss * zterm, zterm
