"""Core: configs, placement policies, topology model, partitioning engine.

The counterpart of ``repro.core``, with its exports but the TPU rates of
``repro.core.topology`` (the port's topology takes every rate as an
argument). ``core.vmesh`` and ``core.dist`` hold the port's meshes: n
ranks as threads on one device, or one process per rank.
"""
from repro_torch.core.config import (
    AllocatorKind,
    ArchConfig,
    AttentionKind,
    HybridConfig,
    LM_SHAPES,
    MLAConfig,
    MeshLayout,
    MoEConfig,
    OSConfig,
    PaddedDims,
    PlacementPolicy,
    RWKVConfig,
    RopeKind,
    RunConfig,
    ShapeConfig,
    ShardingConfig,
    StepKind,
    TrainConfig,
    pad_to,
)
from repro_torch.core.params import (
    ParamDef,
    abstract_params,
    axes_tree,
    init_params,
    param_bytes,
    param_count,
    pdef,
    shapes_tree,
)
from repro_torch.core.partitioning import (
    DEFAULT_RULES,
    MeshSpec,
    NamedSharding,
    PartitionSpec,
    policy_state_spec,
    rules_with,
    spec_for,
    tree_shardings,
    tree_specs,
    validate_spec,
)
from repro_torch.core.topology import TorusTopology
