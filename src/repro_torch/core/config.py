"""The part of ``repro.core.config`` the analytics port needs."""
from __future__ import annotations

import enum


class PlacementPolicy(enum.Enum):
    """NUMA memory-placement policies mapped to shardings (paper Section
    3.3): the distributed lowering's axis. Values match the reference."""

    FIRST_TOUCH = "first_touch"
    INTERLEAVE = "interleave"
    LOCAL_ALLOC = "local_alloc"
    PREFERRED = "preferred"
