"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence.

The counterpart of ``repro.kernels.rwkv6_scan.ref``. Per (batch, head),
with state S in R^{N x N} (key dim i, value dim j):

    y_t[j]  = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
    S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]

``wkv6_ref`` steps along time in float32 with the reference's grouping
and one fixed order of operations: every product and sum is its own
rounded operation, and the sum over the key dim i is a pairwise tree
(adjacent pairs, then pairs of pairs). It is the CPU path of ``wkv6`` and
the yardstick the CUDA kernel is held to; the kernel takes the same
operations in the same order, so the two agree bit for bit. That order is
fixed because rwkv6-7b at full width magnified a difference of one
float32 rounding in y to 2.4e-4 in its logits (on an H100), more than the
1e-4 the kernel's path is held to against this one. ``wkv6_step_ref`` is
one decode step in the reference's own form.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_step_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step. r, k, v, w: (B, H, N); u: (H, N); state: (B, H, N, N)
    float32. Returns (y (B, H, N) float32, the new state)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", rf, state + uf[..., :, None] * kv)
    return y, wf[..., :, None] * state + kv


def pairwise_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 as a pairwise tree: p[0] + p[1], p[2] + p[3], ...,
    then the same over those sums; an odd last entry moves up a level."""
    while p.shape[-2] > 1:
        n = p.shape[-2]
        s = p[..., 0:n - 1:2, :] + p[..., 1:n:2, :]
        p = torch.cat([s, p[..., n - 1:, :]], -2) if n % 2 else s
    return p[..., 0, :]


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, S, H, N); u: (H, N); state (B, H, N, N) or zeros.
    Returns (y (B, S, H, N) float32, the final state (B, H, N, N))."""
    B, S, H, N = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[..., :, None]
    if state is None:
        state = torch.zeros((B, H, N, N), dtype=torch.float32,
                            device=r.device)
    state = state.float()
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, ..., :, None] * vf[:, t, ..., None, :]
        prod = rf[:, t, ..., :, None] * (state + uf * kv)
        y[:, t] = pairwise_sum(prod)
        state = wf[:, t, ..., :, None] * state + kv
    return y, state
