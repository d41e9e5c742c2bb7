"""Dry run: trace every (arch x shape x mesh) cell on fake tensors.

The counterpart of ``repro.launch.dryrun``. For each cell this driver
  1. chooses the cell's run configuration (``cell_config``) or skips it
     (``skip_reason``), as the reference does;
  2. builds the step (``make_train_step``, ``LMModel.prefill`` or
     ``decode_step``) and its inputs as fake tensors
     (``torch._subclasses.FakeTensorMode``) on the card's stand-in
     (``fake_card``): zero device allocation at any model size;
  3. runs it once (``trace``): FLOPs from ``FlopCounterMode`` (the three
     LM kernels are ``torch.library`` operators with FLOP formulas), the
     bytes every operator reads and writes, the peak of live bytes and the
     outputs' shapes and dtypes, with no kernel built or launched;
  4. takes each argument's bytes on one device from the sharding plan of
     the production meshes (``launch.sharding_plan``);
  5. derives the roofline terms from the rates it is given and emits a
     JSON report.

The reference lowers the plain path (``kernel_mode="ref"``); the dry run
traces the kernels' path, the one that runs on the card: the plain scans
are per-token Python loops that cannot be traced in useful time, and the
plain attention materializes scores that the kernel never allocates.
The stand-in (``card_stand_in``) is a fake ``cuda:0`` where the host has
a card and a fake CPU device where it has none (a build of PyTorch
without CUDA aborts the process when autograd meets a CUDA tensor, fake or
not); ``build_cell`` gives the model that device and the kernels' route
(``kernel_mode="cuda"``), and the kernels' checks take a fake tensor for
the card's.

On the pod meshes (16 x 16, 2 x 16 x 16) FLOPs and bytes come from the
trace of the whole step on one device, spread evenly over the chips in
the roofline. The per-device temporaries and the collective bytes come
from a second trace (``trace_cell(..., sharded=True)``): rank 0 of the
sharded step, under a fake process group of the mesh's world size
(``fake_group``), its arguments fake DTensors of the plan's shard shapes
(``fake_sharded``), the live bytes counted on rank 0's local storages
and every ``_c10d_functional`` collective recorded (kind, result bytes,
group size) and priced by the reference's per-kind arithmetic
(``collective_cost``): DTensor's redistributions and, in the MoE
families' expert-parallel dispatch (``build_cell`` gives the model the
mesh as ``moe_mesh``, as the reference does), the all-to-alls and the aux
loss's mean. On the one-card mesh the first trace's peak is the device's.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch recurrentgemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out-dir "$TMPDIR/dryrun"
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import (Any, Callable, Dict, Iterator, Optional, Tuple,
                    Union)

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, init_gpu_context
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.config import (LM_SHAPES, ArchConfig, PlacementPolicy,
                                     RunConfig, ShapeConfig, ShardingConfig,
                                     StepKind, TrainConfig)
from repro_torch.core.params import abstract_params
from repro_torch.core.partitioning import MeshSpec, axis_size
from repro_torch.launch.mesh import device_mesh, make_production_mesh
from repro_torch.launch.sharding_plan import (batch_specs, cache_shardings,
                                              data_axes_for,
                                              opt_state_shardings,
                                              param_shardings)
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_train_step

# NVIDIA H100 SXM data sheet (dense rates, the full 700 W power limit):
# what the CLI passes; ``run_cell`` takes every rate as a keyword.
H100_SXM = dict(peak_flops=989e12,      # bf16 tensor cores, dense
                hbm_bw=3.35e12,         # device memory, bytes/s
                link_bw=4.5e11,         # NVLink, bytes/s each way
                device_memory=80e9)     # 80 GB
H100_SXM_SOURCE = ("NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, "
                   "3.35 TB/s, NVLink 450 GB/s each way, 80 GB")
# the reference's five collective kinds, by the ``_c10d_functional``
# operators that DTensor issues
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# operators of that namespace that move nothing
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
# the namespaces of the functional collectives (PyTorch 2.11 keeps the
# autograd-carrying all-to-all in a namespace of its own)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# caching allocator's rounding of every block (c10's kMinBlockSize)
ALLOC_ROUND = 512


# ---------------------------------------------------------------------------
# per-cell configuration (the reference's defaults; overrides via the CLI)
# ---------------------------------------------------------------------------
def cell_config(arch: ArchConfig, shape: ShapeConfig, *,
                policy: str = "interleave", sequence_parallel: bool = True,
                accum: Optional[int] = None,
                strategy: str = "tp",
                accum_bf16: Optional[bool] = None) -> RunConfig:
    is_deepseek = arch.name == "deepseek-v3"
    is_moe = arch.moe is not None
    big_dense = arch.param_count() > 20e9
    default_accum = 8 if is_deepseek else (4 if is_moe else
                                           (2 if big_dense else 1))
    train = TrainConfig(
        accum_steps=accum if accum is not None else default_accum,
        grad_accum_dtype="bfloat16" if (accum_bf16 if accum_bf16 is not None
                                        else is_deepseek) else "float32",
        moment_dtype="bfloat16" if is_deepseek else "float32",
        master_weights=not is_deepseek,
        remat="block",
    )
    sharding = ShardingConfig(
        policy=PlacementPolicy(policy),
        strategy=strategy,
        sequence_parallel=sequence_parallel and strategy == "tp",
        expert_parallel_data=is_deepseek,
    )
    return RunConfig(arch=arch, shape=shape, sharding=sharding, train=train)


def skip_reason(arch: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return ("skipped: pure full-attention arch — 512k-token dense KV at "
                "batch 1 is not a sub-quadratic-serving shape")
    return None


# ---------------------------------------------------------------------------
# meshes and the arguments' bytes on one device
# ---------------------------------------------------------------------------
def one_card_mesh() -> MeshSpec:
    """The one-card mesh: both axes of size 1."""
    return MeshSpec(("data", "model"), (1, 1), np.zeros((1, 1), np.int64))


def n_chips(mesh: MeshSpec) -> int:
    return int(np.prod(mesh.axis_sizes))


def mesh_name(mesh: MeshSpec) -> str:
    """"16x16", "2x16x16", or "1" for one card."""
    if n_chips(mesh) == 1:
        return "1"
    return "x".join(str(s) for s in mesh.axis_sizes)


def shard_shape(shape, spec, mesh: MeshSpec) -> Tuple[int, ...]:
    """One device's block of a ``shape`` array laid out by ``spec``: each
    dim divided by the size of the mesh axes named for it (the plan's
    specs only name axes that divide their dim)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts):
        size = axis_size(mesh, axis)
        if dim % size:
            raise ValueError(f"dim {dim} does not split over {axis} "
                             f"({size})")
        out.append(dim // size)
    return tuple(out)


def _pairs(values: Any, shardings: Any) -> Iterator[Tuple[Any, Any]]:
    """(leaf, its NamedSharding) over two trees of one structure; a leaf
    is a tensor or a cache's (shape, dtype)."""
    if isinstance(values, dict):
        for k in values:
            yield from _pairs(values[k], shardings[k])
    elif hasattr(values, "_fields"):          # AdamWState
        for v, s in zip(values, shardings):
            if v is not None:
                yield from _pairs(v, s)
    else:
        yield values, shardings


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def argument_bytes_per_device(model: LMModel, cfg: RunConfig,
                              mesh: MeshSpec) -> Dict[str, int]:
    """Each argument group's bytes on one device under the sharding plan
    (params, opt_state and the step for a train step, the batch, the cache
    for decode) and their "total": every leaf's shard shape times its
    itemsize."""
    arch, shape = model.arch, cfg.shape
    params_abs = abstract_params(model.schema(),
                                 getattr(torch, cfg.param_dtype))
    out = {"params": sum(_nbytes(shard_shape(p.shape, s.spec, mesh), p.dtype)
                         for p, s in _pairs(params_abs, param_shardings(
                             model, cfg, mesh)))}
    binfo = batch_specs(arch, shape, mesh, cfg.sharding.strategy)
    out["batch"] = sum(_nbytes(shard_shape(b.shape, s.spec, mesh), b.dtype)
                       for b, s in _pairs(binfo["specs"],
                                          binfo["shardings"]))
    if shape.kind == StepKind.TRAIN:
        opt_abs = adamw.abstract_state(params_abs, cfg.train)
        oshard = opt_state_shardings(model, cfg, mesh, params_abs, opt_abs)
        out["opt_state"] = sum(
            _nbytes(shard_shape(o.shape, s.spec, mesh), o.dtype)
            for o, s in _pairs(opt_abs, oshard))
        out["step"] = torch.int32.itemsize
    elif shape.kind == StepKind.DECODE:
        B, cap = shape.global_batch, shape.seq_len
        spec = model.cache_spec(B, cap)
        out["cache"] = sum(
            _nbytes(shard_shape(leaf[0], s.spec, mesh), leaf[1])
            for leaf, s in _pairs(spec, cache_shardings(
                model, cfg, mesh, B, cap)))
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the trace: FLOPs, bytes, live memory
# ---------------------------------------------------------------------------
def card_stand_in() -> torch.device:
    """The device whose fake tensors stand for the card's: ``cuda:0``
    where there is a card, the CPU where there is none."""
    return (torch.device("cuda", 0) if torch.cuda.is_available()
            else torch.device("cpu"))


@contextlib.contextmanager
def fake_card() -> Iterator[torch.device]:
    """A FakeTensorMode for the card's stand-in (``card_stand_in``), which
    it yields: tensors made inside it allocate nothing, and the kernels'
    operators run their fake implementations (no build, no launch)."""
    device = card_stand_in()
    if device.type == "cuda":
        # FakeTensorMode makes, and frees, one 1-element tensor on a card
        # the first time a process makes a fake tensor there (to set up
        # autograd's context); made here, before the mode opens, it never
        # falls inside a trace
        init_gpu_context(device)
    with FakeTensorMode():
        yield device


# operators that move no bytes: allocation without a write, and
# metadata-only ops that the schema does not mark as views (besides views
# and ``prim`` queries such as a fake tensor's device)
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default,
    torch.ops.aten.detach.default, torch.ops.aten.alias.default,
}


def _tensors(tree: Any):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def collective_cost(kind: str, result_bytes: float,
                    g: int) -> Tuple[float, float]:
    """(operand bytes, wire bytes) on one device of one collective whose
    result on that device has ``result_bytes``, over a group of ``g``: the
    reference's arithmetic (``repro.launch.dryrun.collective_bytes``)."""
    g = max(g, 1)
    if kind == "all-gather":
        return result_bytes / g, result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return result_bytes, 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * g, result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes, result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return result_bytes, result_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_bytes(records) -> Dict[str, Any]:
    """The reference's report of collectives from (kind, result bytes,
    group size) records: per kind its count, operand and wire bytes, and
    their totals."""
    out: Dict[str, Any] = {k: {"count": 0, "operand_bytes": 0.0,
                               "wire_bytes": 0.0} for k in COLLECTIVES}
    for kind, result_b, g in records:
        operand, wire = collective_cost(kind, result_b, g)
        out[kind]["count"] += 1
        out[kind]["operand_bytes"] += operand
        out[kind]["wire_bytes"] += wire
    out["operand_bytes"] = sum(out[k]["operand_bytes"] for k in COLLECTIVES)
    out["wire_bytes"] = sum(out[k]["wire_bytes"] for k in COLLECTIVES)
    return out


def _group_size(func, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


@contextlib.contextmanager
def _rank_ops_only(tracker: "_Tracker") -> Iterator[None]:
    """Around a trace of DTensors, two pieces of DTensor's own bookkeeping
    that are not a rank's work run outside the counters: the sharding
    propagation's run of an operator on global shapes to learn its
    output's (once per operator and placement), and the index arithmetic
    of a strided shard (a dim split over two axes, then flattened), which
    builds index tensors and reads them back, so that it runs on real
    ones under a fake mode too."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    def quiet(orig, real=False):
        def run(*a, **k):
            tracker.paused += 1
            try:
                if real:
                    with unset_fake_temporarily():
                        return orig(*a, **k)
                return orig(*a, **k)
            finally:
                tracker.paused -= 1
        return run
    prop = DTensor._op_dispatcher.sharding_propagator
    meta = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta") if hasattr(prop, n))
    strided = getattr(_StridedShard, "local_shard_size_and_offset", None)
    setattr(prop, meta, quiet(getattr(prop, meta)))
    if strided is not None:
        _StridedShard.local_shard_size_and_offset = quiet(strided, real=True)
    try:
        yield
    finally:
        delattr(prop, meta)
        if strided is not None:
            _StridedShard.local_shard_size_and_offset = strided


class _Tracker(TorchDispatchMode):
    """Counts, over every operator that runs, the bytes of its tensor
    inputs and outputs on ``device`` (views and metadata-only operators
    left out), and follows the live bytes of ``device``'s storages: each
    storage an operator makes is counted, rounded up as the caching
    allocator rounds it, from its creation until it is freed. On DTensors
    it sees each rank's local operators (DTensor's own dispatch hands them
    down), so the bytes are this rank's, and it records every collective
    as (kind, result bytes, group size)."""

    def __init__(self, device: torch.device):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.paused = 0
        self.collectives: list = []
        self._seen = WeakIdKeyDictionary()
        self._alias = WeakIdKeyDictionary()

    def adopt(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors (the step's arguments;
        a DTensor's local block) as live."""
        for t in _tensors(tree):
            self._note(_local(t))

    def _note(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented       # DTensor hands down its local ops
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if func._opname in _NOT_COLLECTIVES:
                self._alias_of(_tensors(args)[0], out)
                return out
            kind = _COLLECTIVE_KINDS.get(func._opname)
            if kind is None:
                raise NotImplementedError(f"no cost for collective {func}")
            self.collectives.append(
                (kind, sum(t.numel() * t.element_size()
                           for t in _tensors(out)),
                 _group_size(func, args)))
        if func.namespace != "prim" and func not in _NO_TRAFFIC and \
                not func.is_view:
            for t in _tensors((args, kwargs)) + _tensors(out):
                if t.device == self.device:
                    self.bytes += t.numel() * t.element_size()
        for t in _tensors(out):
            self._note(t)
        return out

    def _alias_of(self, src: torch.Tensor, out: Any) -> None:
        """A collective's result, waited on or wrapped for autograd, is
        one buffer whichever tensor holds it (fake and real runs make a
        new tensor here or not): counted once, live while either holds
        it."""
        for t in _tensors(out):
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = 0
                self._alias[st] = src


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, _dtensor_type()) else t


def describe(tree: Any) -> Any:
    """``tree`` with each tensor as [shape, dtype name] and a NamedTuple
    as a dict of its fields."""
    if isinstance(tree, torch.Tensor):
        return [list(tree.shape), str(tree.dtype).replace("torch.", "")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: describe(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: describe(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [describe(v) for v in tree]
    return tree


def trace(fn: Callable, args: Tuple, device: torch.device
          ) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the counters: FLOPs
    (``FlopCounterMode``, the kernels' operators by their formulas), the
    bytes every operator reads and writes on ``device`` (eager PyTorch
    launches a kernel an operator, so this is the eager path's
    device-memory traffic before caches), the live bytes at the start
    (the arguments) and at their peak, the collectives, and the outputs'
    shapes and dtypes. On fake tensors nothing is allocated or launched;
    on real ones the same counters describe a real run. On DTensors the
    bytes, the live bytes and the collectives are this rank's (FLOPs are
    not counted: ``FlopCounterMode`` sees global and local shapes both)."""
    tracker = _Tracker(device)
    tracker.adopt(args)
    start = tracker.live
    sharded = any(isinstance(t, _dtensor_type()) for t in _tensors(args))
    t0 = time.perf_counter()
    if sharded:
        with _rank_ops_only(tracker), tracker:
            out = fn(*args)
        flops = None
    else:
        with FlopCounterMode(display=False) as flop_counter, tracker:
            out = fn(*args)
        flops = int(flop_counter.get_total_flops())
    seconds = time.perf_counter() - t0
    return {"flops": flops,
            "bytes": int(tracker.bytes),
            "argument_bytes": int(start),
            "peak_bytes": int(tracker.peak),
            "step_peak_bytes": int(tracker.peak - start),
            "collectives": collective_bytes(tracker.collectives),
            "collective_records": list(tracker.collectives),
            "outputs": describe(out),
            "seconds": seconds}


def fake_like(tree: Any, device: torch.device) -> Any:
    """Fake tensors on ``device`` with the shapes and dtypes of ``tree``'s
    ``meta`` tensors or (shape, dtype) leaves (call inside ``fake_card``)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(fake_like(v, device) for v in tree))
    if isinstance(tree, dict):
        return {k: fake_like(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        shape, dtype = tree
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def model_tp(mesh: MeshSpec, cfg: RunConfig) -> int:
    """The model's tensor-parallel padding: the mesh's "model" size, 1
    under fsdp or decode_dshard (as the reference)."""
    if cfg.sharding.strategy == "fsdp" or cfg.sharding.decode_dshard:
        return 1
    return mesh.shape["model"]


@contextlib.contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """A fake process group (``torch.distributed``'s "fake" backend) in
    which this process is rank 0 of ``world_size``: collectives return at
    once, so one process traces rank 0 of a mesh of any size. Raises if a
    group is already initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_sharded(tree: Any, shardings: Any, dmesh,
                 device: torch.device) -> Any:
    """Fake DTensors on ``dmesh`` with the shapes and dtypes of ``tree``'s
    ``meta`` tensors or (shape, dtype) leaves, each rank's block of the
    plan's shard shape (``shard_shape``) made on its own, so that a local
    storage holds that block alone (call inside ``fake_card``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.partitioning import placements
    from repro_torch.launch.sharding_plan import _tree_map

    def place(leaf, s):
        shape, dtype = ((tuple(leaf.shape), leaf.dtype)
                        if isinstance(leaf, torch.Tensor) else leaf)
        local = torch.empty(shard_shape(shape, s.spec, s.mesh), dtype=dtype,
                            device=device)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, dmesh, placements(s.spec, s.mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)
    return _tree_map(place, tree, shardings)


def build_cell(arch: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
               cfg: RunConfig, kernel_mode: Optional[str] = None,
               dmesh=None):
    """(model, step function, its arguments as fake tensors on the card's
    stand-in). Call inside ``fake_card``. The model runs the kernels'
    route on the stand-in; ``kernel_mode="ref"`` traces the plain versions
    in place of the kernels' operators. With ``dmesh`` (the
    ``DeviceMesh`` of ``mesh`` over a ``fake_group``) the arguments are
    fake DTensors placed by the plan and the step is the sharded one; an
    MoE model then takes the mesh as ``moe_mesh`` for a full-sequence step
    under sequence parallelism, its experts over ("data", "model") with
    ``expert_parallel_data``, else over "model" (the reference's
    choices; the whole step's trace keeps the one-device dispatch)."""
    dev = card_stand_in()
    data_axes = data_axes_for(mesh) + (
        ("model",) if cfg.sharding.strategy == "fsdp" else ())
    use_sharded_moe = (arch.moe is not None and dmesh is not None
                       and cfg.sharding.sequence_parallel
                       and shape.kind != StepKind.DECODE)
    expert_axes = (("data", "model") if cfg.sharding.expert_parallel_data
                   else ("model",))
    model = LMModel(arch, tp=model_tp(mesh, cfg), remat=cfg.train.remat,
                    sequence_parallel=cfg.sharding.sequence_parallel,
                    data_axes=data_axes,
                    kernel_mode=kernel_mode or "cuda", device=dev,
                    moe_mesh=dmesh if use_sharded_moe else None,
                    expert_axes=expert_axes)
    if dmesh is None:
        def make(tree, _shardings):
            return fake_like(tree, dev)
    else:
        def make(tree, shardings):
            return fake_sharded(tree, shardings, dmesh, dev)
    params_abs = abstract_params(model.schema(),
                                 getattr(torch, cfg.param_dtype))
    params = make(params_abs, dmesh and param_shardings(model, cfg, mesh))
    binfo = batch_specs(arch, shape, mesh, cfg.sharding.strategy)
    data = make(binfo["specs"], binfo["shardings"])
    if shape.kind == StepKind.TRAIN:
        opt_abs = adamw.abstract_state(params_abs, cfg.train)
        opt = make(opt_abs, dmesh and opt_state_shardings(
            model, cfg, mesh, params_abs, opt_abs))
        return model, make_train_step(model, cfg), (params, opt, data, 0)
    if shape.kind == StepKind.PREFILL:
        return model, model.prefill, (params, data)
    B, cap = shape.global_batch, shape.seq_len
    cache = make(model.cache_spec(B, cap),
                 dmesh and cache_shardings(model, cfg, mesh, B, cap))
    return model, model.decode_step, (params, cache, data)


def trace_cell(arch: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
               cfg: RunConfig, kernel_mode: Optional[str] = None,
               sharded: bool = False, dmesh=None) -> Dict[str, Any]:
    """The counterpart of the reference's ``_cell_costs``: one pass of the
    cell's step on fake tensors (``trace``), and the device it stood on.
    ``sharded`` traces rank 0 of the sharded step on ``mesh`` instead of
    the whole step on one device, under a ``fake_group`` of its own, or
    on ``dmesh`` (the ``DeviceMesh`` of ``mesh`` over a fake group that
    the caller holds)."""
    if sharded and dmesh is None:
        with fake_group(n_chips(mesh)):
            return trace_cell(arch, shape, mesh, cfg, kernel_mode, True,
                              device_mesh(mesh, card_stand_in().type))
    with fake_card() as dev:
        _, fn, args = build_cell(arch, shape, mesh, cfg, kernel_mode,
                                 dmesh=dmesh if sharded else None)
        out = trace(fn, args, dev)
    out["trace_device"] = str(dev)
    return out


# ---------------------------------------------------------------------------
# depth calibration: a full-depth trace where it fits the time budget;
# where the step runs a per-token Python loop (the WKV6 backward, autograd
# through the plain ``wkv6_ref``, ~16 ms a token a layer on fake tensors:
# rwkv6-7b's train_4k would take ~35 min at full depth, ~3 min as two
# shallow traces), or where rank 0's sharded trace of a deep MoE stack
# with leading dense layers would (deepseek-v3: 61 layers, 8
# microbatches), shallow traces extrapolated linearly in depth.
# ---------------------------------------------------------------------------
_COST_KEYS = ("flops", "bytes", "step_peak_bytes")
_SHARDED_KEYS = ("bytes", "step_peak_bytes")


def needs_calibration(arch: ArchConfig, shape: ShapeConfig,
                      sharded: bool = False) -> bool:
    """True where a full-depth trace would step a plain scan token by
    token (rwkv's train step: its WKV6 backward) and, for rank 0's
    sharded trace, for an MoE stack with leading dense layers that is
    deeper than its calibration traces."""
    if arch.family == "ssm" and shape.kind == StepKind.TRAIN:
        return True
    return sharded and arch.moe is not None and \
        arch.moe.n_dense_layers > 0 and \
        arch.n_layers > calibration_depths(arch)[1]


def _extrapolate(c1: Any, c2: Any, n: int) -> Any:
    """c1 + (c2 - c1) (n - 1) over numbers and dicts of them."""
    if isinstance(c1, dict):
        return {k: _extrapolate(c1[k], c2[k], n) for k in c1}
    return c1 + (c2 - c1) * (n - 1)


def calibrate_costs(arch: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
                    cfg: RunConfig, sharded: bool = False
                    ) -> Dict[str, Any]:
    """Full-depth FLOPs, bytes and step peak of a stack of identical
    layers, extrapolated from traces at 1 and 2 layers; of an MoE stack
    with leading dense layers, per MoE layer from traces at two depths
    after them (``calibration_depths``: the reference's calibration).
    Eager costs are linear in the depth of such a stack (one stacked leaf
    a parameter, every layer the same operators), so FLOPs and bytes are
    exact. The peak is not additive in general: on the reduced configs
    that the tests also trace at full depth it is exact for train and
    decode steps (the only cells ``run_cell`` extrapolates are train
    steps) and over by at most two of the allocator's blocks for a
    prefill. The reference's hybrid super-block structure is not ported:
    those stacks trace at full depth. ``sharded`` extrapolates rank 0's
    sharded trace the same way, its collectives (every layer of a stack
    issues the same) with it."""
    n1, n2 = calibration_depths(arch)
    if arch.family == "hybrid":
        raise ValueError(f"{arch.name}: calibrate_costs extrapolates a "
                         "stack of identical layers")
    if arch.n_layers < n1:
        raise ValueError(f"{arch.name}: calibrate_costs extrapolates a "
                         f"stack of identical layers from {n1} layers up; "
                         f"{arch.n_layers} are fewer")
    c1, c2 = (trace_cell(dataclasses.replace(arch, n_layers=n), shape, mesh,
                         cfg, sharded=sharded) for n in (n1, n2))
    keys = _SHARDED_KEYS + ("collectives",) if sharded else _COST_KEYS
    return {k: _extrapolate(c1[k], c2[k], arch.n_layers - n1 + 1)
            for k in keys}


def calibration_depths(arch: ArchConfig) -> Tuple[int, int]:
    """The two depths ``calibrate_costs`` traces: one and two layers of a
    stack of identical layers; two and three MoE layers after an MoE
    stack's leading dense layers (the reference takes one and two: on
    DTensors a step with one MoE layer moves other bytes than the next
    layer adds, while two to three to four add the same, reduced
    deepseek-v3 on a (2, 2) mesh, tests/test_torch_dryrun_depth.py)."""
    nd = arch.moe.n_dense_layers if arch.moe is not None else 0
    return (nd + 2, nd + 3) if nd else (1, 2)


def cell_costs(arch: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
               cfg: RunConfig, sharded: bool = False) -> Dict[str, Any]:
    """The traced costs ``run_cell`` reports: ``trace_cell``'s at full
    depth, or ``calibrate_costs``' where a cell needs calibration."""
    if needs_calibration(arch, shape, sharded):
        return calibrate_costs(arch, shape, mesh, cfg, sharded=sharded)
    return trace_cell(arch, shape, mesh, cfg, sharded=sharded)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def model_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    """6 N_active D a trained token, 2 N_active D a prefilled or generated
    one (the reference's)."""
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != StepKind.DECODE else 1)
    mult = 6.0 if shape.kind == StepKind.TRAIN else 2.0
    return mult * arch.active_param_count() * tokens


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig],
             *, multi_pod: bool,
             peak_flops: float, hbm_bw: float, link_bw: float,
             device_memory: float, rates_source: str = "",
             one_card: bool = False,
             policy: str = "interleave", sequence_parallel: bool = True,
             accum: Optional[int] = None, strategy: str = "tp",
             accum_bf16: Optional[bool] = None,
             decode_dshard: bool = False,
             param_dtype: Optional[str] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """The cell's report. ``arch`` and ``shape`` are names
    (``configs.ARCHS``, ``LM_SHAPES``) or configs (a cut of one).
    ``one_card`` traces the one-card mesh (both axes of size 1), where the
    trace's peak is the device's; otherwise the production mesh
    (``multi_pod``: 2 x 16 x 16, else 16 x 16). ``param_dtype`` replaces
    ``cell_config``'s parameter dtype."""
    arch = get_arch(arch) if isinstance(arch, str) else arch
    shape = LM_SHAPES[shape] if isinstance(shape, str) else shape
    arch_name, shape_name = arch.name, shape.name
    mesh = one_card_mesh() if one_card else \
        make_production_mesh(multi_pod=multi_pod)
    report: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name, "n_layers": arch.n_layers,
        "mesh": mesh_name(mesh),
        "policy": policy, "sequence_parallel": sequence_parallel,
        "strategy": strategy,
    }
    reason = skip_reason(arch, shape)
    if reason:
        report["status"] = "skipped"
        report["reason"] = reason
        return report

    cfg = cell_config(arch, shape, policy=policy,
                      sequence_parallel=sequence_parallel, accum=accum,
                      strategy=strategy, accum_bf16=accum_bf16)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if decode_dshard:
        report["decode_dshard"] = True
        cfg = dataclasses.replace(
            cfg, sharding=dataclasses.replace(cfg.sharding,
                                              decode_dshard=True))
    report["accum_steps"] = cfg.train.accum_steps
    report["param_dtype"] = cfg.param_dtype
    chips = n_chips(mesh)

    # ---- the arguments on one device, from the sharding plan ---------------
    plan_model = LMModel(arch, tp=model_tp(mesh, cfg), device="meta")
    args_b = argument_bytes_per_device(plan_model, cfg, mesh)

    # ---- the trace ----------------------------------------------------------
    t0 = time.perf_counter()
    cost = cell_costs(arch, shape, mesh, cfg)
    if needs_calibration(arch, shape):
        report["depth"] = "extrapolated from traces at %d and %d layers" \
            % calibration_depths(arch)
        report["outputs"] = None
    else:
        report["depth"] = "full"
        report["outputs"] = cost["outputs"]
        report["trace_device"] = cost["trace_device"]
    # ---- rank 0 of the sharded step on a pod mesh ---------------------------
    shard = None
    if chips > 1:
        shard = cell_costs(arch, shape, mesh, cfg, sharded=True)
        if needs_calibration(arch, shape, sharded=True):
            report["sharded_depth"] = "extrapolated from traces at " \
                "%d and %d layers" % calibration_depths(arch)
    report["trace_s"] = round(time.perf_counter() - t0, 1)
    report["status"] = "ok"

    # ---- memory (proves it fits) ------------------------------------------
    report["argument_bytes_per_device"] = args_b
    temp_b = (cost if shard is None else shard)["step_peak_bytes"]
    per_device = args_b["total"] + temp_b
    report["temp_bytes_per_device"] = temp_b
    report["bytes_per_device"] = per_device
    report["fits"] = bool(per_device < device_memory)
    report["device_memory"] = device_memory

    # ---- FLOPs, bytes, collectives ------------------------------------------
    report["flops"] = float(cost["flops"])
    report["flops_per_device"] = cost["flops"] / chips
    report["bytes_accessed"] = float(cost["bytes"])
    report["bytes_accessed_per_device"] = cost["bytes"] / chips
    if shard is None:
        coll = 0.0
        report["collective_operand_bytes_per_device"] = 0.0
        report["collective_wire_bytes_per_device"] = 0.0
    else:
        coll = shard["collectives"]["wire_bytes"]
        report["collectives"] = shard["collectives"]
        report["collective_operand_bytes_per_device"] = \
            shard["collectives"]["operand_bytes"]
        report["collective_wire_bytes_per_device"] = coll

    # ---- roofline terms -------------------------------------------------------
    compute_s = report["flops"] / (chips * peak_flops)
    memory_s = report["bytes_accessed"] / (chips * hbm_bw)
    collective_s = coll / link_bw
    terms = [("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)]
    report["roofline"] = {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max(terms, key=lambda kv: kv[1])[0],
    }
    report["rates"] = {"peak_flops": peak_flops, "hbm_bw": hbm_bw,
                       "link_bw": link_bw, "device_memory": device_memory,
                       "source": rates_source}
    mflops = model_flops(arch, shape)
    report["model_flops"] = mflops
    report["useful_flops_ratio"] = (mflops / report["flops"]
                                    if report["flops"] else None)
    step_s = max(s for _, s in terms)
    report["roofline"]["step_s_lower_bound"] = step_s
    report["roofline"]["mfu_bound"] = (
        mflops / (step_s * chips * peak_flops) if step_s > 0 else None)
    if verbose:
        print(json.dumps(report, indent=2, default=str))
    return report


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--one-card", action="store_true",
                    help="the one-card mesh in place of the production one")
    ap.add_argument("--policy", default="interleave",
                    choices=[p.value for p in PlacementPolicy])
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence parallelism")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--accum-bf16", action="store_true")
    ap.add_argument("--decode-dshard", action="store_true",
                    help="shard decode KV caches over head_dim (INTERLEAVE "
                         "applied to the cache: avoids kv-head padding)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    cells = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(LM_SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = ([None] if args.one_card else
            {"off": [False], "on": [True], "both": [False, True]}[
                args.multi_pod])
    for a in archs:
        for s in shapes:
            for mp in pods:
                cells.append((a, s, mp))

    failures = 0
    for a, s, mp in cells:
        where = "card" if mp is None else ("multi" if mp else "single")
        tag = f"{a}|{s}|{where}"
        try:
            rep = run_cell(a, s, multi_pod=bool(mp), one_card=mp is None,
                           rates_source=H100_SXM_SOURCE, **H100_SXM,
                           policy=args.policy,
                           sequence_parallel=not args.no_sp,
                           accum=args.accum, strategy=args.strategy,
                           accum_bf16=args.accum_bf16 or None,
                           decode_dshard=args.decode_dshard)
        except Exception as e:  # noqa: BLE001 — report and continue
            rep = {"arch": a, "shape": s,
                   "mesh": {"card": "1", "multi": "2x16x16",
                            "single": "16x16"}[where],
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            failures += 1
            print(f"[FAIL] {tag}: {e}", file=sys.stderr)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            fname = f"{a}_{s}_{where}"
            if args.policy != "interleave":
                fname += f"_{args.policy}"
            if args.no_sp:
                fname += "_nosp"
            if args.strategy != "tp":
                fname += f"_{args.strategy}"
            if args.accum_bf16:
                fname += "_accbf16"
            if args.decode_dshard:
                fname += "_dshard"
            with open(os.path.join(args.out_dir, fname + ".json"), "w") as f:
                json.dump(rep, f, indent=2, default=str)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
