"""Parameter schema: declare, then materialize.

The counterpart of ``repro.core.params``. Models build a nested dict
*schema* of ``ParamDef`` leaves (shape math only, no device memory), laid
out as the reference lays it out: a homogeneous layer stack is one
``ParamDef`` with a leading layer axis (``blocks/sub{i}/...`` for the
hybrid pattern, ``blocks/...`` for a dense stack) and a pattern's tail is
``tail{i}``. The port walks that stack with a Python loop over views.

``init_params`` draws every leaf from the same distribution with the same
scale as the reference's ``_materialize``, from a ``torch.Generator``; the
bits differ. ``abstract_params`` gives the same tree as tensors on the
``meta`` device (shape and dtype, no storage); ``axes_tree`` and
``shapes_tree`` give each leaf's logical axes and shape. ``from_reference`` carries the reference's own parameter (or
cache) tree across as numpy arrays, which is how the tests give both
packages the same weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | scaled | uniform
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in) for scaled
    dtype: Optional[str] = None    # per-param dtype override ("float32", ...)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")


def pdef(shape: Sequence[int], axes: Sequence[Optional[str]],
         init: str = "normal", scale: Optional[float] = None,
         dtype: Optional[str] = None) -> ParamDef:
    return ParamDef(tuple(int(s) for s in shape), tuple(axes), init, scale,
                    dtype)


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def _iter_items(schema: Dict[str, Any], prefix: str = ""):
    for k in sorted(schema):
        v = schema[k]
        path = f"{prefix}/{k}" if prefix else k
        if is_def(v):
            yield path, v
        elif isinstance(v, dict):
            yield from _iter_items(v, path)
        else:
            raise TypeError(f"schema leaf {path} has type {type(v)}")


def _torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _materialize(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    out_dtype = _torch_dtype(d.dtype) if d.dtype else dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=out_dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=out_dtype, device=device)
    if d.init == "uniform":
        scale = d.scale if d.scale is not None else 1.0
        u = torch.rand(d.shape, generator=gen, device=device)
        return u.mul_(2 * scale).sub_(scale).to(out_dtype)
    if d.init == "scaled":
        # the reference's conservative fan-in: the product of every
        # non-output dim, the stacked layer axis included
        fan_in = 1
        for s in d.shape[:-1]:
            fan_in *= s
        scale = (d.scale if d.scale is not None
                 else float(np.sqrt(1.0 / max(1, fan_in))))
    else:
        scale = d.scale if d.scale is not None else 0.02
    # scaled in place: a leaf never takes twice its size (a stacked
    # expert leaf of phi3.5-moe is 18.75 GiB)
    return torch.randn(d.shape, generator=gen, device=device).mul_(
        scale).to(out_dtype)


def init_params(schema: Dict[str, Any], generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Union[None, str, torch.device] = None
                ) -> Dict[str, Any]:
    """Materialize real parameter tensors on ``device`` (the generator's
    device when None), leaves drawn in sorted-path order."""
    dev = torch.device(device) if device is not None else generator.device

    def build(node: Dict[str, Any]) -> Dict[str, Any]:
        return {k: (_materialize(node[k], generator, dtype, dev)
                    if is_def(node[k]) else build(node[k]))
                for k in sorted(node)}
    return build(schema)


def abstract_params(schema: Dict[str, Any],
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: each leaf's shape and dtype
    (its own override, else ``dtype``) with no storage behind it."""
    def build(node):
        return {k: (torch.empty(v.shape, device="meta",
                                dtype=_torch_dtype(v.dtype or dtype))
                    if is_def(v) else build(v))
                for k, v in node.items()}
    return build(schema)


def axes_tree(schema: Dict[str, Any]) -> Dict[str, Any]:
    def build(node):
        return {k: (v.axes if is_def(v) else build(v)) for k, v in node.items()}
    return build(schema)


def shapes_tree(schema: Dict[str, Any]) -> Dict[str, Any]:
    def build(node):
        return {k: (v.shape if is_def(v) else build(v)) for k, v in node.items()}
    return build(schema)


def param_count(schema: Dict[str, Any]) -> int:
    total = 0
    for _, d in _iter_items(schema):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total


def param_bytes(schema: Dict[str, Any], default_bytes: int = 2) -> int:
    total = 0
    for _, d in _iter_items(schema):
        n = 1
        for s in d.shape:
            n *= s
        itemsize = (_torch_dtype(d.dtype).itemsize if d.dtype
                    else default_bytes)
        total += n * itemsize
    return total


def _to_tensor(x: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # numpy has no bfloat16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_reference(tree: Any, device: Union[None, str, torch.device] = None
                   ) -> Any:
    """The reference's parameter or cache tree (nested dicts of arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the port's tree of
    tensors on ``device`` (the CUDA device by default; it raises without
    one, so pass ``device="cpu"`` for the CPU). The layout is the same:
    stacked ``blocks/sub{i}/...`` and ``blocks/...`` keep their leading
    layer axis and ``tail{i}`` stays apart. Dtypes are kept (bfloat16
    included)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_reference(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)
