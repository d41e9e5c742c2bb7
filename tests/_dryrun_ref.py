"""Helpers shared by the dry run's tests: the port's run configuration as
the reference's, reduced configs at widths the LM kernels take, and real
tensors like the dry run's fake ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core import config as ref_config
from repro.core.params import abstract_params as ref_abstract
from repro.models.lm import LMModel as RefLM
from repro.optim import adamw as ref_adamw
from repro.runtime.train_loop import make_train_step
from repro_torch.configs.reduced import REDUCED
from repro_torch.core import config
from repro_torch.launch.sharding_plan import batch_specs


def ref_cfg(cfg, ref_arch, ref_shape):
    """The port's RunConfig as the reference's, on ``ref_arch`` and
    ``ref_shape`` (the same fields)."""
    sh = dataclasses.asdict(cfg.sharding)
    sh["policy"] = ref_config.PlacementPolicy(cfg.sharding.policy.value)
    sh["mesh_layout"] = ref_config.MeshLayout(cfg.sharding.mesh_layout.value)
    return ref_config.RunConfig(
        arch=ref_arch, shape=ref_shape,
        sharding=ref_config.ShardingConfig(**sh),
        train=ref_config.TrainConfig(**dataclasses.asdict(cfg.train)),
        param_dtype=cfg.param_dtype)


def ref_shape(shape):
    return ref_config.ShapeConfig(shape.name,
                                  ref_config.StepKind(shape.kind.value),
                                  shape.seq_len, shape.global_batch)


def kernel_widths(arch, cfg_mod):
    """``arch`` at widths the LM kernels take: attention head dim 64, or
    deepseek-v3's published MLA heads (128 + 64, v 128) at 2 heads; rwkv's
    head of 16 is one of the WKV6 kernel's."""
    if arch.rwkv is not None:
        return arch
    if arch.mla is not None:
        return dataclasses.replace(
            arch, n_heads=2, n_kv_heads=2, mla=cfg_mod.MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128))
    return dataclasses.replace(arch, head_dim=64)


def reduced_pair(name, **replace):
    """(port arch, reference arch): the reduced config at kernel widths,
    with ``replace`` applied to both."""
    port = kernel_widths(REDUCED[name], config)
    ref = kernel_widths(REF_REDUCED[name], ref_config)
    return (dataclasses.replace(port, **replace),
            dataclasses.replace(ref, **replace))


def described_ref(tree):
    """The reference's output tree as the dry run describes the port's:
    each leaf [shape, dtype name], a NamedTuple as a dict of its fields."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: described_ref(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: described_ref(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [described_ref(v) for v in tree]
    if tree is None:
        return None
    return [list(tree.shape), jnp.dtype(tree.dtype).name]


def sds(tree):
    """``meta`` tensors or (shape, torch dtype) leaves as the reference's
    ShapeDtypeStructs."""
    if isinstance(tree, dict):
        return {k: sds(v) for k, v in tree.items()}
    shape, dtype = (tree if isinstance(tree, tuple)
                    else (tuple(tree.shape), tree.dtype))
    return jax.ShapeDtypeStruct(tuple(shape), jnp.dtype(
        str(dtype).replace("torch.", "")))


def real_like(tree, vocab, seed=0):
    """Real CPU tensors with the shapes and dtypes of ``tree``'s ``meta``
    tensors: integers below ``vocab`` (token ids; a patch grid's positions
    too), floats from a normal draw scaled to 0.02."""
    rng = np.random.RandomState(seed)
    if isinstance(tree, dict):
        return {k: real_like(v, vocab, seed + i)
                for i, (k, v) in enumerate(sorted(tree.items()))}
    if tree.dtype.is_floating_point:
        return torch.from_numpy(
            rng.randn(*tree.shape).astype(np.float32) * 0.02).to(tree.dtype)
    return torch.from_numpy(rng.randint(0, vocab, tree.shape)).to(tree.dtype)


def cell_shape(kind, seq, batch):
    """A shape of the port's with ``kind``, ``seq`` and ``batch``."""
    return config.ShapeConfig(f"{kind.value}_test", kind, seq, batch)


def as_lists(tree):
    """Tuples as lists, as JSON would give them."""
    if isinstance(tree, dict):
        return {k: as_lists(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [as_lists(v) for v in tree]
    return tree


def reference_outputs(ref_arch, arch, shape, cfg, mesh):
    """``jax.eval_shape`` of the reference's step for the cell (the train
    step, the prefill or one decode step), described as the dry run
    describes the port's outputs."""
    rcfg = ref_cfg(cfg, ref_arch, ref_shape(shape))
    model = RefLM(ref_arch, tp=1, remat=cfg.train.remat)
    params = ref_abstract(model.schema(), jnp.dtype(cfg.param_dtype))
    batch = sds(batch_specs(arch, shape, mesh)["specs"])
    if shape.kind == config.StepKind.TRAIN:
        opt = ref_adamw.abstract_state(params, rcfg.train)
        out = jax.eval_shape(make_train_step(model, rcfg), params, opt,
                             batch, jax.ShapeDtypeStruct((), jnp.int32))
    elif shape.kind == config.StepKind.PREFILL:
        out = jax.eval_shape(model.prefill, params, batch)
    else:
        cache = model.cache_spec(shape.global_batch, shape.seq_len)
        out = jax.eval_shape(model.decode_step, params, cache, batch)
    return described_ref(out)
