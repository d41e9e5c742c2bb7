"""Production mesh construction.

The counterpart of ``repro.launch.mesh``. Each function returns a
``core.partitioning.MeshSpec``: the axis names and sizes, and the grid of
ranks that each logical coordinate maps to. ``make_production_mesh`` is
the reference's 16 x 16 (or 2 x 16 x 16) plan with ranks in row-major
order, a description that needs no devices; ``make_layout_mesh``
permutes the ranks per the thread-placement analogue
(``core.meshes.layout_device_order``) and, as the reference, raises when
the host has fewer devices than the topology; ``make_host_mesh`` spans
the devices there are: the ranks of the ``torch.distributed`` group when
one is initialized, else the CUDA devices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.config import MeshLayout
from repro_torch.core.meshes import layout_device_order
from repro_torch.core.partitioning import MeshSpec
from repro_torch.core.topology import TorusTopology


def _device_count() -> int:
    """The world size of the initialized process group, else the CUDA
    device count; raises when that is 0."""
    n = (dist.get_world_size() if dist.is_available() and
         dist.is_initialized() else torch.cuda.device_count())
    if n < 1:
        raise RuntimeError("no CUDA device and no process group")
    return n


def _grid_mesh(shape, axes) -> MeshSpec:
    n = int(np.prod(shape))
    return MeshSpec(tuple(axes), tuple(shape),
                    np.arange(n).reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid_mesh(shape, axes)


def make_layout_mesh(*, multi_pod: bool = False,
                     layout: MeshLayout = MeshLayout.SPARSE) -> MeshSpec:
    """The production shape, ranks permuted per the layout: NONE is the
    topology-oblivious OS baseline, SPARSE/DENSE the affinitized ones."""
    topo = TorusTopology(n_pods=2 if multi_pod else 1)
    order = layout_device_order(layout, topo)   # (pods, x, y) of ranks
    have = _device_count()
    if have < topo.n_chips:
        raise ValueError(f"need {topo.n_chips} devices, have {have}")
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), order.shape, order)
    return MeshSpec(("data", "model"), order.shape[1:], order[0])


def make_host_mesh(n_data: Optional[int] = None,
                   n_model: int = 1) -> MeshSpec:
    """A (data, model) mesh over the devices there are (tests,
    examples)."""
    n = _device_count()
    n_data = n_data or (n // n_model)
    if n_data * n_model != n:
        raise ValueError(f"a {n_data} x {n_model} mesh over {n} devices")
    return _grid_mesh((n_data, n_model), ("data", "model"))
