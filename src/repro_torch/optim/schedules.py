"""LR schedules (pure functions of the step counter), the counterpart of
``repro.optim.schedules``: float32 tensors on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 (so step 0 has lr 0), then a cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``."""
    s = torch.as_tensor(step).float()
    warm = peak_lr * s / max(1, warmup_steps)
    prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                       0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step), peak_lr,
                           dtype=torch.float32)
