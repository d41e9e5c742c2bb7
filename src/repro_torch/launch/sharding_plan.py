"""The full sharding plan for one (arch x shape x mesh x policy) cell.

The counterpart of ``repro.launch.sharding_plan``; one place decides
every placement:
  params      logical axes -> mesh axes via the partitioning rules (TP over
              "model"; MoE experts over "model", or ("data", "model") for
              deepseek-scale EP)
  opt state   the params' plan + the NUMA placement policy (FIRST_TOUCH =
              replicated over data = naive DP; INTERLEAVE = ZeRO-1)
  batch       batch dim over the data axes
  kv cache    batch over data, kv_heads over model, recurrent state ditto

Meshes are ``core.partitioning.MeshSpec``; specs are its
``PartitionSpec``; shardings its ``NamedSharding`` (mesh, spec) pairs;
``batch_specs`` gives ``meta`` tensors where the reference gives
``ShapeDtypeStruct``. The plan is data: no step of the port places a
tensor by it yet. A step over several cards would apply it, each named
axis of a spec a shard of that dimension over a ``torch.distributed``
device mesh, each None a replica.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.config import (ArchConfig, RunConfig, ShapeConfig,
                                     StepKind)
from repro_torch.core.params import axes_tree, shapes_tree
from repro_torch.core.partitioning import (MeshSpec, NamedSharding, P,
                                           PartitionSpec, map_axes, named,
                                           policy_state_spec, rules_with,
                                           spec_for, tree_specs,
                                           validate_spec)
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw


def data_axes_for(mesh: MeshSpec) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_rules(cfg: RunConfig, mesh: MeshSpec) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    if cfg.sharding.expert_parallel_data:
        # EP group = ("data", "model"); the pod axis replicates experts
        overrides["expert"] = ("data", "model")
    if cfg.sharding.decode_dshard:
        # decode: shard head_dim instead of (padded) heads, and the MLA
        # latent cache over "model"
        overrides["heads"] = None
        overrides["kv_heads"] = None
        overrides["head_dim"] = "model"
        overrides["kv_lora"] = "model"
    return rules_with(overrides)


def _dp(mesh: MeshSpec, strategy: str = "tp"):
    axes = data_axes_for(mesh)
    if strategy == "fsdp":               # batch over EVERY axis
        axes = axes + ("model",)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _fsdp_spec(shape, mesh: MeshSpec) -> PartitionSpec:
    """FSDP storage sharding: the largest divisible dim over "data", the
    second largest over "model"."""
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    parts = [None] * len(shape)
    for axis in ("data", "model"):
        size = mesh.shape.get(axis, 1)
        for i in dims:
            if parts[i] is None and shape[i] % size == 0 and \
                    shape[i] >= size:
                parts[i] = axis
                break
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def param_specs(model: LMModel, cfg: RunConfig, mesh: MeshSpec):
    schema = model.schema()
    if cfg.sharding.strategy == "fsdp":
        return map_axes(lambda _, shp: _fsdp_spec(shp, mesh),
                        axes_tree(schema), shapes_tree(schema))
    return tree_specs(axes_tree(schema), make_rules(cfg, mesh), mesh,
                      shapes_tree(schema))


def _over_specs(fn, spec_tree: Any, *trees: Any) -> Any:
    if isinstance(spec_tree, PartitionSpec):
        return fn(spec_tree, *trees)
    return {k: _over_specs(fn, v, *(t[k] for t in trees))
            for k, v in spec_tree.items()}


def param_shardings(model: LMModel, cfg: RunConfig, mesh: MeshSpec):
    return _over_specs(lambda s: named(mesh, s),
                       param_specs(model, cfg, mesh))


def opt_state_shardings(model: LMModel, cfg: RunConfig, mesh: MeshSpec,
                        params_abs: Any, opt_abs: adamw.AdamWState
                        ) -> adamw.AdamWState:
    """The placement policy applied to the moments and master weights
    (``opt_abs`` from ``adamw.abstract_state`` or ``adamw.init``)."""
    pspecs = param_specs(model, cfg, mesh)
    policy = cfg.sharding.policy

    def state_shard(abs_tree):
        return _over_specs(lambda s, ab: named(mesh, policy_state_spec(
            policy, s, ab.shape, mesh)), pspecs, abs_tree)

    master = (state_shard(opt_abs.master)
              if opt_abs.master is not None else None)
    return adamw.AdamWState(named(mesh, P()), state_shard(opt_abs.mu),
                            state_shard(opt_abs.nu), master)


def batch_specs(arch: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
                strategy: str = "tp") -> Dict[str, Any]:
    """{"specs": meta tensors, "shardings": NamedShardings} of this cell's
    input batch."""
    dp = _dp(mesh, strategy)
    B = shape.global_batch
    S = shape.seq_len if shape.kind != StepKind.DECODE else 1
    specs: Dict[str, torch.Tensor] = {}
    shards: Dict[str, NamedSharding] = {}

    def add(name, shp, dtype, spec):
        specs[name] = torch.empty(shp, dtype=dtype, device="meta")
        shards[name] = named(mesh, validate_spec(shp, spec, mesh))

    if arch.n_codebooks:
        if shape.kind == StepKind.DECODE:
            add("codes", (B, 1, arch.n_codebooks), torch.int32, P(dp))
        else:
            add("embeds", (B, S, arch.d_model), torch.bfloat16, P(dp))
            if shape.kind == StepKind.TRAIN:
                add("labels", (B, S, arch.n_codebooks), torch.int32, P(dp))
    elif arch.vlm and shape.kind != StepKind.DECODE:
        n_patch = arch.n_patches
        add("tokens", (B, S - n_patch), torch.int32, P(dp))
        add("patch_embeds", (B, n_patch, arch.d_model), torch.bfloat16,
            P(dp))
        add("patch_pos", (B, n_patch, 3), torch.int32, P(dp))
        if shape.kind == StepKind.TRAIN:
            add("labels", (B, S - n_patch), torch.int32, P(dp))
    else:
        add("tokens", (B, S), torch.int32, P(dp))
        if shape.kind == StepKind.TRAIN:
            add("labels", (B, S), torch.int32, P(dp))
    return {"specs": specs, "shardings": shards}


def cache_shardings(model: LMModel, cfg: RunConfig, mesh: MeshSpec,
                    batch: int, cap: int):
    """Each cache leaf's sharding, over ``LMModel.cache_axes`` and
    ``cache_spec``'s (shape, dtype) leaves."""
    rules = make_rules(cfg, mesh)       # includes the decode_dshard rules
    return map_axes(lambda ax, s: named(mesh, validate_spec(
        s[0], spec_for(ax, rules, mesh), mesh)), model.cache_axes(),
        model.cache_spec(batch, cap))
