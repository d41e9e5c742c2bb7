"""Kernel dispatch: hand-written CUDA kernel | plain PyTorch version.

The counterpart of ``repro.kernels.common``. There is no interpret mode:
a CUDA kernel runs on the card or not at all. The modes are

  * mode="auto":  the CUDA kernel for a tensor on a CUDA device, the plain
                  PyTorch version for a tensor on the CPU;
  * mode="cuda":  force the CUDA kernel (a CPU tensor then raises);
  * mode="ref":   force the plain PyTorch version.

Set globally via env REPRO_TORCH_KERNEL_MODE or per call with ``mode``.
The choice follows the tensor's device, never the machine: a CUDA tensor
under "auto" launches the kernel or raises, it never falls back.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import torch

ENV_VAR = "REPRO_TORCH_KERNEL_MODE"
_VALID = ("auto", "cuda", "ref")


def kernel_mode(mode: Optional[str] = None,
                device: Optional[torch.device] = None) -> str:
    """Resolve ``mode`` to "cuda" or "ref" for data on ``device``.

    Without a device, "auto" stays "auto" (the planner asks before any
    tensor exists)."""
    mode = mode or os.environ.get(ENV_VAR, "auto")
    if mode not in _VALID:
        raise ValueError(f"kernel mode {mode!r} not in {_VALID}")
    if mode == "auto" and device is not None:
        return "cuda" if torch.device(device).type == "cuda" else "ref"
    return mode


# Launch counts of the hand-written kernels. Each wrapper adds one where it
# launches its kernel and nowhere else, so a run can show that its main path
# went through the kernels (chip_smoke.py zeroes them around the main path).
# The shards of a virtual mesh launch from threads, hence the lock.
LAUNCHES = {"hash_aggregate_multi": 0, "join_probe": 0,
            "block_histograms": 0, "flash_attention": 0, "rglru_scan": 0,
            "wkv6": 0}
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def check_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                shape: tuple, device: torch.device,
                contiguous: bool = True) -> None:
    """Raise unless ``t`` is what a CUDA kernel takes: a tensor of
    ``dtype`` and ``shape`` on the CUDA device ``device``, contiguous (or,
    with ``contiguous=False``, contiguous in its last dim)."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name} must lie on {device}, a CUDA device; "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous and t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the integer handle a C
    launcher takes."""
    return torch.cuda.current_stream(device).cuda_stream


def pick_block(size: int, preferred: int, minimum: int = 8) -> int:
    """Largest divisor-block <= preferred for a dimension of ``size``."""
    b = min(preferred, size)
    while size % b and b > minimum:
        b -= 1
    return max(b, 1) if size % max(b, 1) == 0 else size
