"""Fault tolerance: straggler detection, elastic re-meshing, failure drill.

The counterpart of ``repro.runtime.ft``, the same logic (numpy only):

  * per-host step times (EWMA) flag hosts whose smoothed time exceeds
    ``threshold`` x the fleet median; the mitigation is demotion (shrink
    the mesh without the slow host) or data-share rebalancing;
  * the largest valid mesh is rebuilt from the surviving devices on
    failure (elastic re-mesh);
  * a deterministic FailureInjector exercises the checkpoint/restart path
    in tests and on the card, not just in documents.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


class SimulatedFailure(RuntimeError):
    """Raised by FailureInjector at scheduled steps."""


@dataclass
class FailureInjector:
    fail_at_steps: Sequence[int] = ()
    kill_hosts: int = 0            # hosts lost per failure (elastic drill)
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step} "
                                   f"(-{self.kill_hosts} hosts)")


@dataclass
class StragglerReport:
    host: int
    ewma: float
    median: float
    ratio: float


class StragglerDetector:
    """EWMA per-host step times vs fleet median."""

    def __init__(self, n_hosts: int, alpha: float = 0.3,
                 threshold: float = 1.5, warmup: int = 3):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self._ewma = np.zeros(n_hosts)
        self._count = np.zeros(n_hosts, dtype=int)

    def record(self, host: int, seconds: float) -> None:
        if self._count[host] == 0:
            self._ewma[host] = seconds
        else:
            self._ewma[host] = (self.alpha * seconds
                                + (1 - self.alpha) * self._ewma[host])
        self._count[host] += 1

    def stragglers(self) -> List[StragglerReport]:
        ready = self._count >= self.warmup
        if ready.sum() < 2:
            return []
        med = float(np.median(self._ewma[ready]))
        out = []
        for h in range(self.n_hosts):
            if ready[h] and self._ewma[h] > self.threshold * med:
                out.append(StragglerReport(h, float(self._ewma[h]), med,
                                           float(self._ewma[h] / med)))
        return out

    def data_shares(self) -> np.ndarray:
        """Mitigation: per-host batch shares inversely proportional to the
        smoothed step time (slow hosts get less data; synchronous steps
        equalize). Normalized to sum to 1."""
        ready = self._count >= 1
        t = np.where(ready, np.maximum(self._ewma, 1e-9), 1.0)
        inv = 1.0 / t
        return inv / inv.sum()


def elastic_mesh_shape(n_devices: int, model_parallel: int
                       ) -> Tuple[int, int]:
    """Largest (data, model) grid that fits the surviving device count,
    keeping TP intact (model_parallel is fixed by the checkpointed layout;
    shrinking happens on the data axis — ZeRO/DP state reshards freely)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{n_devices} devices — TP degradation requires repartitioning")
    data = n_devices // model_parallel
    return data, model_parallel


def surviving_devices(devices: Sequence, n_lost: int) -> List:
    """Deterministically drop the last ``n_lost`` devices (drill stand-in
    for the real runtime's failed-host report)."""
    if n_lost <= 0:
        return list(devices)
    return list(devices)[:len(devices) - n_lost]
