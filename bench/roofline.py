"""Frozen roofline formulas of the analytics kernels and the H100's rates.

A kernel's share of its roofline is the least time the card could take
for the work its launches' shapes need, over the device time its kernels
took. The work counts each input byte read once and each output byte
written once (NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s
of float32 outside the tensor cores; the card's power limit is reported
beside every run).
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least seconds for ``n_bytes`` moved and ``n_ops`` f32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def hash_aggregate_multi(P: int, T: int, C: int, n_bins: int
                         ) -> Tuple[float, float]:
    """(bytes, ops): ids (P, T) int32 and vals (P, T, C) f32 read, the
    (P, n_bins, C) f32 sums written; one add a value."""
    return 4.0 * (P * T + P * T * C + P * n_bins * C), float(P * T * C)


def join_probe(P: int, Bk: int, Pk: int) -> Tuple[float, float]:
    """(bytes, ops): build keys and values (P, Bk) int32 + f32 and probe
    keys (P, Pk) int32 read, vals f32 and found bool (P, Pk) written; one
    insert a build slot and one lookup a probe slot."""
    return 8.0 * P * Bk + 4.0 * P * Pk + 5.0 * P * Pk, float(P * (Bk + Pk))


# The kernels of each launch, by the names they take in a device trace.
KERNEL_NAMES = {"hash_aggregate_multi": ("agg_partial_kernel",
                                         "agg_reduce_kernel"),
                "join_probe": ("join_build_kernel", "join_probe_kernel")}
FORMULAS = {"hash_aggregate_multi": hash_aggregate_multi,
            "join_probe": join_probe}
