"""The part of ``repro.core.config`` the analytics port needs, and the
device rule every entry point of the port shares."""
from __future__ import annotations

import enum
from typing import Union

import torch


class PlacementPolicy(enum.Enum):
    """NUMA memory-placement policies mapped to shardings (paper Section
    3.3): the distributed lowering's axis. Values match the reference."""

    FIRST_TOUCH = "first_touch"
    INTERLEAVE = "interleave"
    LOCAL_ALLOC = "local_alloc"
    PREFERRED = "preferred"


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``device``, or the CUDA device when None. Raises when the result is
    a CUDA device and there is none: pass ``device="cpu"`` for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
