"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value with at
    least q% of all values at or below it. Every value counts."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100 * len(s)))
    return s[k - 1]


def rate(count: float, seconds: float) -> float:
    """Work done in a window over the window's whole length."""
    if seconds <= 0:
        raise ValueError("a window must have a length")
    return count / seconds

