"""Logical-to-physical mesh layouts: the thread-placement analogue.

A copy of ``repro.core.meshes`` (numpy permutations) on the port's
``core.topology``; its ``layout_report`` equals the reference's.

The paper (Section 3.2) shows that *where* threads land relative to the
topology decides cache behaviour and local-access ratio, and that the OS
default (free migration) is both slow and high-variance. On an accelerator
mesh the runtime does not migrate programs, but the *assignment of logical
mesh coordinates to physical chips* plays the same role: it decides which collectives ride 1-hop
physical rings and which are diluted across the torus.

Layouts (see core.config.MeshLayout):
  DENSE   model-parallel groups contiguous (one torus row per TP group):
          TP collectives are 1-hop, DP collectives cross rows.
  SPARSE  data-parallel groups contiguous (one torus column per DP ring):
          DP collectives are 1-hop; TP groups spread across columns — each TP
          group spans all 16 columns' worth of distinct links (paper: maximize
          aggregate bandwidth).
  NONE    a fixed pseudo-random permutation, modeling the topology-oblivious
          "OS scheduler" baseline (deterministic so results are reproducible,
          but deliberately locality-free).

All layouts are permutations of the same device set, so the program is
identical; the difference is priced by ``core.topology``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.config import MeshLayout
from repro_torch.core.topology import TorusTopology, ring_neighbor_hops


def _derangement(n: int, seed: int = 0xDA7A) -> np.ndarray:
    """Deterministic pseudo-random permutation of range(n)."""
    rng = np.random.RandomState(seed)
    return rng.permutation(n)


def layout_device_order(layout: MeshLayout, topo: TorusTopology) -> np.ndarray:
    """Return physical device indices arranged as the logical mesh grid.

    Output shape: (n_pods, xdim, ydim) -> logical ("pod", "data", "model")
    (single-pod callers squeeze the pod axis). Entry [p, d, m] is the physical
    chip index that hosts logical coordinate (pod=p, data=d, model=m).
    """
    n = topo.n_chips
    base = np.arange(n).reshape(topo.n_pods, topo.xdim, topo.ydim)
    if layout == MeshLayout.DENSE:
        # logical model axis == physical y (rows contiguous): TP 1-hop rings
        return base
    if layout == MeshLayout.SPARSE:
        # logical data axis == physical y: DP 1-hop rings, TP spread over x
        return base.transpose(0, 2, 1)
    # NONE: topology-oblivious permutation
    perm = _derangement(n)
    return perm.reshape(topo.n_pods, topo.xdim, topo.ydim)


def axis_rings(order: np.ndarray, axis: int) -> List[List[int]]:
    """Enumerate the device rings formed along one logical axis."""
    moved = np.moveaxis(order, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    return [list(map(int, row)) for row in flat]


def mean_axis_hops(layout: MeshLayout, topo: TorusTopology,
                   logical_axis: str) -> float:
    """Mean ring-neighbour hop distance for collectives over one axis."""
    order = layout_device_order(layout, topo)
    axis_index = {"pod": 0, "data": 1, "model": 2}[logical_axis]
    rings = axis_rings(order, axis_index)
    hops = [ring_neighbor_hops(topo, r) for r in rings if len(r) > 1]
    return float(np.mean(hops)) if hops else 0.0


def layout_report(topo: TorusTopology) -> dict:
    """Hop-dilution table for every layout x axis."""
    report = {}
    for layout in MeshLayout:
        report[layout.value] = {
            ax: mean_axis_hops(layout, topo, ax)
            for ax in ("data", "model")
        }
    return report
