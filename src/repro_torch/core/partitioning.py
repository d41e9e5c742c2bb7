"""Logical-axis partitioning engine (t5x-style) and the placement policies.

The counterpart of ``repro.core.partitioning``. Models annotate every
parameter with logical axis names (("vocab", "embed"), ("heads",
"head_dim", "embed"), ...); a rule table maps logical axes onto mesh axes;
the NUMA placement policy decides how state arrays (optimizer moments,
caches) spread over the data axes:

  FIRST_TOUCH  state keeps the computation's sharding and is replicated
               along the data axes (each data-parallel group first-touches
               its own copy);
  INTERLEAVE   state is also sharded round-robin over the data axes
               (ZeRO-1 for optimizer state);
  LOCAL_ALLOC, PREFERRED   lower as FIRST_TOUCH; their cost lives in the
               cost model.

The port has no jax ``Mesh``: ``MeshSpec`` carries what the reference
reads of one, its axis names and their sizes (``shape``), and the rank
grid (``devices``, from ``launch.mesh``). ``PartitionSpec`` is a tuple,
one entry a dimension: None, a mesh axis name or a tuple of names.
``named`` and ``tree_shardings`` return ``NamedSharding`` (mesh, spec)
pairs, the reference's ``jax.sharding.NamedSharding`` as plain data.
``placements`` turns a spec into DTensor placements, one a mesh axis: the
form in which the sharded step applies it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.config import PlacementPolicy


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, and its grid of ranks (an int array
    of shape ``axis_sizes``, or None for a mesh with no devices bound)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[np.ndarray] = field(default=None, compare=False,
                                          repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices is not None and \
                tuple(self.devices.shape) != tuple(self.axis_sizes):
            raise ValueError(f"device grid {self.devices.shape} is not "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


class NamedSharding(NamedTuple):
    mesh: MeshSpec
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# Logical-axis rules
# ---------------------------------------------------------------------------
# Default rule table for the production mesh ("pod", "data", "model").
# None -> replicated along that logical axis.
DEFAULT_RULES: Dict[str, Optional[Any]] = {
    # embeddings / projections
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "d_rnn": "model",
    # MoE
    "expert": "model",            # overridden to ("data","model") for big EP
    "expert_ff": None,
    # MLA latents
    "q_lora": None,
    "kv_lora": None,
    # rwkv
    "rwkv_heads": "model",
    "lora": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",            # sequence-parallel residual stream
    # stacked layer dim
    "layers": None,
}


def rules_with(overrides: Mapping[str, Any]) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    rules.update(overrides)
    return rules


def _present(mesh: MeshSpec, axis: Any) -> Optional[Any]:
    """Drop mesh axes that don't exist (e.g. 'pod' on the single-pod
    mesh)."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh.axis_names)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in mesh.axis_names else None


def spec_for(logical_axes: Sequence[Optional[str]], rules: Mapping[str, Any],
             mesh: MeshSpec) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec on ``mesh``."""
    parts = []
    used: set = set()
    for name in logical_axes:
        axis = _present(mesh, rules.get(name)) if name else None
        # a mesh axis may appear at most once in a spec
        if axis is not None:
            flat = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in flat):
                axis = None
            else:
                used.update(flat)
        parts.append(axis)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def axis_size(mesh: MeshSpec, axis: Any) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def validate_spec(shape: Sequence[int], spec: PartitionSpec,
                  mesh: MeshSpec) -> PartitionSpec:
    """Drop sharding on any dim the axis size does not divide (callers pad
    dims ahead of time)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, axis in zip(shape, parts):
        size = axis_size(mesh, axis)
        fixed.append(axis if size > 1 and dim % size == 0 else
                     (axis if size == 1 else None))
    while fixed and fixed[-1] is None:
        fixed.pop()
    return P(*fixed)


# ---------------------------------------------------------------------------
# Placement policies applied to state arrays
# ---------------------------------------------------------------------------
def _data_axes(mesh: MeshSpec) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def policy_state_spec(policy: PlacementPolicy, base_spec: PartitionSpec,
                      shape: Sequence[int], mesh: MeshSpec) -> PartitionSpec:
    """Sharding for a state array whose computation sharding is
    ``base_spec``: FIRST_TOUCH keeps it; INTERLEAVE also spreads the
    largest unsharded dimension that the data axes divide over them."""
    base_spec = validate_spec(shape, base_spec, mesh)
    if policy != PlacementPolicy.INTERLEAVE:
        return base_spec
    parts = list(base_spec) + [None] * (len(shape) - len(base_spec))
    used: set = set()
    for axis in parts:
        if axis is None:
            continue
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            used.add(a)
    data_axes = tuple(a for a in _data_axes(mesh) if a not in used)
    if not data_axes:
        return base_spec
    dsize = axis_size(mesh, data_axes)
    best_dim, best_len = -1, 0
    for i, (dim, axis) in enumerate(zip(shape, parts)):
        if axis is None and dim % dsize == 0 and dim > best_len:
            best_dim, best_len = i, dim
    if best_dim < 0:
        return base_spec
    parts[best_dim] = data_axes if len(data_axes) > 1 else data_axes[0]
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def named(mesh: MeshSpec, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def placements(spec: PartitionSpec, mesh: MeshSpec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh axis in
    mesh order: ``Shard(dim)`` on every axis of more than one rank that
    ``spec`` names for ``dim``, ``Replicate()`` on the others (a split in
    one is the whole tensor, and DTensor's view rules refuse to merge or
    drop a dim that is split, however many ways). A dim over several
    axes, such as ("pod", "data"), is split by each in turn, the first the
    major one, which is the reference's layout when the axes come in mesh
    order (the only order a plan names them in; another raises)."""
    from torch.distributed.tensor import Replicate, Shard
    out: list = [Replicate() for _ in mesh.axis_names]
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        where = [mesh.axis_names.index(a) for a in names]
        if where != sorted(where):
            raise ValueError(f"{spec}: axes {names} of dim {dim} are not in "
                             f"the mesh's order {mesh.axis_names}")
        for i in where:
            if mesh.axis_sizes[i] > 1:
                out[i] = Shard(dim)
    return out


# ---------------------------------------------------------------------------
# Tree utilities over (schema | params, logical-axes) trees
# ---------------------------------------------------------------------------
def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_axes(fn, axes_tree: Any, *trees: Any) -> Any:
    """fn(axes, leaves...) over a tree whose leaves are logical-axes
    tuples and trees of the same structure."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    return {k: map_axes(fn, v, *(t[k] for t in trees))
            for k, v in axes_tree.items()}


def tree_specs(axes_tree: Any, rules: Mapping[str, Any], mesh: MeshSpec,
               shapes_tree: Any) -> Any:
    """A PartitionSpec tree from logical-axes and shapes trees."""
    return map_axes(lambda axes, shape: validate_spec(
        shape, spec_for(axes, rules, mesh), mesh), axes_tree, shapes_tree)


def tree_shardings(axes_tree: Any, rules: Mapping[str, Any], mesh: MeshSpec,
                   shapes_tree: Any) -> Any:
    return map_axes(lambda axes, shape: named(mesh, validate_spec(
        shape, spec_for(axes, rules, mesh), mesh)), axes_tree, shapes_tree)
