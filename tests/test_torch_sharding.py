"""The port's partitioning engine, sharding plan, meshes and LMModel's
TP padding and expert-parallel wiring against the JAX reference on the
CPU.

The reference's plan reads two things of a mesh, its axis names and
sizes, so it runs here in-process on a ``jax.sharding.AbstractMesh``
(no devices) and the port on a ``core.partitioning.MeshSpec`` of the same
axes: every spec is held bit for bit, for every config of
``repro_torch.configs`` on the production 16 x 16 and 2 x 16 x 16 meshes
(params and optimizer state under FIRST_TOUCH and INTERLEAVE, TP and
FSDP; batches for the train, prefill and decode shapes; caches with and
without decode_dshard). ``LMModel(tp=2)`` is held to the reference's
forward at reduced size (logits within 1e-4, as tests/test_torch_lm.py).
The MoE wiring (``moe_mesh``) runs reduced
phi3.5-moe and deepseek-v3 (a shared expert) on a 4-shard virtual mesh
against the reference's ``shard_map`` path on 4 fake CPU devices (one
subprocess): logits and aux within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from conftest import run_with_devices
from repro.configs import ARCHS as REF_ARCHS
from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core import config as ref_config
from repro.core import partitioning as ref_part
from repro.core.meshes import layout_device_order as ref_layout_order
from repro.core.params import abstract_params as ref_abstract
from repro.core.topology import TorusTopology as RefTorus
from repro.launch import mesh as ref_mesh
from repro.launch import sharding_plan as ref_plan
from repro.models.lm import LMModel as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import REDUCED
from repro_torch.core import config, partitioning
from repro_torch.core.params import abstract_params
from repro_torch.core.partitioning import MeshSpec, P
from repro_torch.core.vmesh import VirtualMesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding_plan as plan
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw

CPU = torch.device("cpu")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = ("FIRST_TOUCH", "INTERLEAVE")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), MeshSpec(axes, sizes)


def spec(x):
    """A spec as a plain tuple: the reference's PartitionSpec or NamedSharding,
    or the port's PartitionSpec or NamedSharding."""
    if hasattr(x, "spec"):
        x = x.spec
    return tuple(x)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def ref_flat(tree, is_leaf):
    return flat(jax.tree.map(lambda x: x, tree, is_leaf=is_leaf))


@functools.lru_cache(maxsize=None)
def models(name, tp):
    return (RefLM(REF_ARCHS[name], tp=tp),
            LMModel(ARCHS[name], tp=tp, device=CPU))


def run_configs(name, policy="INTERLEAVE", strategy="tp", **sharding):
    kw = dict(policy=policy, strategy=strategy, **sharding)
    ref = ref_config.RunConfig(
        arch=REF_ARCHS[name], shape=ref_config.LM_SHAPES["train_4k"],
        sharding=ref_config.ShardingConfig(
            **{**kw, "policy": ref_config.PlacementPolicy[policy]}))
    port = config.RunConfig(
        arch=ARCHS[name], shape=config.LM_SHAPES["train_4k"],
        sharding=config.ShardingConfig(
            **{**kw, "policy": config.PlacementPolicy[policy]}))
    return ref, port


def is_ref_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def is_ref_sharding(x):
    return isinstance(x, jax.sharding.NamedSharding)


# ---------------------------------------------------------------------------
# params and optimizer state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_and_opt_state_specs_match_reference(name, policy, strategy,
                                                   mesh_name):
    tp = 16 if strategy == "tp" else 1
    ref_model, model = models(name, tp)
    ref_cfg, cfg = run_configs(name, policy, strategy)
    rmesh, pmesh = meshes(mesh_name)
    want = ref_flat(ref_plan.param_specs(ref_model, ref_cfg, rmesh),
                    is_ref_spec)
    got = flat(plan.param_specs(model, cfg, pmesh))
    assert {k: spec(v) for k, v in got.items()} == \
        {k: spec(v) for k, v in want.items()}
    assert all(isinstance(v, partitioning.PartitionSpec)
               for v in got.values())

    r_abs = ref_abstract(ref_model.schema(), jnp.bfloat16)
    p_abs = abstract_params(model.schema())
    r_state = ref_plan.opt_state_shardings(
        ref_model, ref_cfg, rmesh, r_abs,
        ref_adamw.abstract_state(r_abs, ref_cfg.train))
    p_state = plan.opt_state_shardings(
        model, cfg, pmesh, p_abs, adamw.abstract_state(p_abs, cfg.train))
    assert spec(p_state.step) == spec(r_state.step) == ()
    for field in ("mu", "nu", "master"):
        w = ref_flat(getattr(r_state, field), is_ref_sharding)
        g = flat(getattr(p_state, field))
        assert {k: spec(v) for k, v in g.items()} == \
            {k: spec(v) for k, v in w.items()}, field
        assert all(v.mesh is pmesh for v in g.values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ["deepseek-v3", "phi3.5-moe"])
def test_expert_parallel_data_specs_match_reference(name, mesh_name):
    ref_model, model = models(name, 16)
    ref_cfg, cfg = run_configs(name, expert_parallel_data=True)
    rmesh, pmesh = meshes(mesh_name)
    want = ref_flat(ref_plan.param_specs(ref_model, ref_cfg, rmesh),
                    is_ref_spec)
    got = flat(plan.param_specs(model, cfg, pmesh))
    assert {k: spec(v) for k, v in got.items()} == \
        {k: spec(v) for k, v in want.items()}
    # deepseek's 256 experts split over the 256 (data, model) ranks;
    # phi3.5-moe's 16 do not, and stay replicated in both packages
    assert any(("data", "model") in spec(v) for v in got.values()) == \
        (name == "deepseek-v3")


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_specs_match_reference(name, shape, strategy, mesh_name):
    rmesh, pmesh = meshes(mesh_name)
    want = ref_plan.batch_specs(REF_ARCHS[name], ref_config.LM_SHAPES[shape],
                                rmesh, strategy)
    got = plan.batch_specs(ARCHS[name], config.LM_SHAPES[shape], pmesh,
                           strategy)
    assert sorted(got["specs"]) == sorted(want["specs"])
    for k, w in want["specs"].items():
        g = got["specs"][k]
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert spec(got["shardings"][k]) == spec(want["shardings"][k])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("dshard", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_shardings_match_reference(name, dshard, mesh_name):
    tp = 1 if dshard else 16
    ref_model, model = models(name, tp)
    ref_cfg, cfg = run_configs(name, decode_dshard=dshard)
    rmesh, pmesh = meshes(mesh_name)
    want = ref_flat(ref_plan.cache_shardings(ref_model, ref_cfg, rmesh, 128,
                                             32768), is_ref_sharding)
    got = flat(plan.cache_shardings(model, cfg, pmesh, 128, 32768))
    assert {k: spec(v) for k, v in got.items()} == \
        {k: spec(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the partitioning engine on random inputs
# ---------------------------------------------------------------------------
AXES = [None, "vocab", "embed", "heads", "kv_heads", "ff", "expert", "batch",
        "seq_sp", "layers", "d_rnn", "kv_lora", "head_dim"]
MESH_AXES = [None, "pod", "data", "model", ("data", "model"),
             ("pod", "data"), ("model", "data")]


@pytest.mark.parametrize("seed", range(4))
def test_engine_matches_reference_on_random_specs(seed):
    rng = np.random.RandomState(seed)
    for _ in range(100):
        mesh_name = list(MESHES)[rng.randint(2)]
        rmesh, pmesh = meshes(mesh_name)
        rank = rng.randint(0, 5)
        logical = tuple(AXES[i] for i in rng.randint(0, len(AXES), rank))
        shape = tuple(int(x) for x in rng.choice([1, 3, 16, 32, 48, 256,
                                                   4096], rank))
        overrides = {"heads": MESH_AXES[rng.randint(len(MESH_AXES))]}
        rules_r = ref_part.rules_with(overrides)
        rules_p = partitioning.rules_with(overrides)
        assert rules_r == rules_p
        want = ref_part.spec_for(logical, rules_r, rmesh)
        got = partitioning.spec_for(logical, rules_p, pmesh)
        assert spec(got) == spec(want)
        present = [a for a in MESH_AXES if a is None or set(
            a if isinstance(a, tuple) else (a,)) <= set(pmesh.axis_names)]
        base = tuple(present[i] for i in rng.randint(0, len(present), rank))
        assert spec(partitioning.validate_spec(shape, P(*base), pmesh)) == \
            spec(ref_part.validate_spec(shape, jax.sharding.PartitionSpec(
                *base), rmesh))
        for pol in POLICIES:
            assert spec(partitioning.policy_state_spec(
                config.PlacementPolicy[pol], got, shape, pmesh)) == \
                spec(ref_part.policy_state_spec(
                    ref_config.PlacementPolicy[pol], want, shape, rmesh))
    assert partitioning.DEFAULT_RULES == ref_part.DEFAULT_RULES


def test_named_and_tree_shardings_pair_mesh_and_spec():
    _, model = models("qwen2-0.5b", 16)
    ref_model, _ = models("qwen2-0.5b", 16)
    rmesh, pmesh = meshes("16x16")
    from repro.core.params import axes_tree as r_axes, shapes_tree as r_shp
    from repro_torch.core.params import axes_tree, shapes_tree
    got = flat(partitioning.tree_shardings(
        axes_tree(model.schema()), partitioning.DEFAULT_RULES, pmesh,
        shapes_tree(model.schema())))
    want = ref_flat(ref_part.tree_shardings(
        r_axes(ref_model.schema()), ref_part.DEFAULT_RULES, rmesh,
        r_shp(ref_model.schema())), is_ref_sharding)
    assert {k: spec(v) for k, v in got.items()} == \
        {k: spec(v) for k, v in want.items()}
    s = partitioning.named(pmesh, P("data"))
    assert s.mesh is pmesh and s.spec == P("data") and s == (pmesh, ("data",))
    assert pmesh.shape == dict(rmesh.shape)
    assert repr(P("data", None)) == "PartitionSpec('data', None)"
    with pytest.raises(ValueError, match="differ in length"):
        MeshSpec(("data",), (2, 2))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_and_layout_meshes(monkeypatch, multi_pod):
    m = tmesh.make_production_mesh(multi_pod=multi_pod)
    sizes, axes = MESHES["2x16x16" if multi_pod else "16x16"]
    assert m.axis_names == axes and m.axis_sizes == sizes
    assert np.array_equal(m.devices.reshape(-1), np.arange(np.prod(sizes)))
    # the reference raises on this host's one device, and so does the port
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError) as want:
        ref_mesh.make_layout_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError) as got:
        tmesh.make_layout_mesh(multi_pod=multi_pod)
    assert str(got.value) == str(want.value)
    n = 512 if multi_pod else 256
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    for layout in config.MeshLayout:
        m = tmesh.make_layout_mesh(multi_pod=multi_pod, layout=layout)
        order = ref_layout_order(ref_config.MeshLayout[layout.name],
                                 RefTorus(n_pods=2 if multi_pod else 1))
        assert m.axis_sizes == sizes
        assert np.array_equal(m.devices,
                              order if multi_pod else order[0])


def test_host_mesh_counts_the_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    want = ref_mesh.make_host_mesh()
    got = tmesh.make_host_mesh()
    assert got.shape == dict(want.shape)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert tmesh.make_host_mesh().axis_sizes == (8, 1)
    assert tmesh.make_host_mesh(n_model=2).axis_sizes == (4, 2)
    assert tmesh.make_host_mesh(2, 4).axis_sizes == (2, 4)
    with pytest.raises(ValueError, match="over 8 devices"):
        tmesh.make_host_mesh(3, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh()


# ---------------------------------------------------------------------------
# LMModel: TP padding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(REDUCED))
def test_tp_padded_schema_matches_reference(name):
    for tp in (2, 16):
        want = flat(jax.tree.map(
            lambda d: (d.shape, d.axes), RefLM(REF_REDUCED[name],
                                               tp=tp).schema(),
            is_leaf=lambda d: hasattr(d, "axes")))
        got = {k: (v.shape, v.axes) for k, v in flat(
            LMModel(REDUCED[name], tp=tp, device=CPU).schema()).items()}
        assert got == want, tp


@pytest.mark.parametrize("name", ["qwen2-0.5b", "phi3.5-moe"])
def test_tp2_forward_matches_reference(name):
    ref_arch = REF_REDUCED[name]
    arch = REDUCED[name]
    if name == "phi3.5-moe":     # a leading dense layer of its own width
        kw = dict(n_dense_layers=1, dense_d_ff=47)
        ref_arch = dataclasses.replace(ref_arch, moe=dataclasses.replace(
            ref_arch.moe, **kw))
        arch = dataclasses.replace(arch, moe=dataclasses.replace(arch.moe,
                                                                 **kw))
    ref_model = RefLM(ref_arch, tp=2, remat="none")
    model = LMModel(arch, tp=2, remat="none", device=CPU)
    params = model.init_params(seed=1)
    tokens = np.random.RandomState(2).randint(1, arch.vocab_size, (2, 12))
    want, _, want_aux = jax.jit(ref_model.forward)(
        jax.tree.map(lambda v: jnp.asarray(v.numpy()), params),
        {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.no_grad():
        got, _, aux = model.forward(
            params, {"tokens": torch.from_numpy(tokens.astype(np.int32))})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# LMModel: the expert-parallel wiring
# ---------------------------------------------------------------------------
EP_ARCHS = ("phi3.5-moe", "deepseek-v3")
EP_SHARDS, EP_B, EP_S = 4, 2, 16

REF_EP = r'''
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.reduced import REDUCED
from repro.models.lm import LMModel

inp = dict(np.load(IN_PATH))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
out = {}
for name in EP_ARCHS:
    params = {}
    for k, v in inp.items():
        if k.startswith(name + "/p/"):
            node = params
            parts = k[len(name + "/p/"):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(v)
    model = LMModel(REDUCED[name], tp=1, sequence_parallel=True,
                    moe_mesh=mesh, expert_axes=("model",), remat="none")
    logits, _, aux = jax.jit(model.forward)(
        params, {"tokens": jnp.asarray(inp[name + "/tokens"])})
    out[name + "/logits"], out[name + "/aux"] = np.asarray(logits), \
        np.asarray(aux)
np.savez(OUT_PATH, **out)
'''


@pytest.fixture(scope="module")
def ep_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_ep")
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    arrays = {}
    for i, name in enumerate(EP_ARCHS):
        params = LMModel(REDUCED[name], device=CPU).init_params(seed=i)
        arrays.update({f"{name}/p/{k}": v.numpy()
                       for k, v in flat(params).items()})
        arrays[f"{name}/tokens"] = np.random.RandomState(i).randint(
            1, REDUCED[name].vocab_size, (EP_B, EP_S)).astype(np.int32)
    np.savez(inp, **arrays)
    run_with_devices(REF_EP.replace("IN_PATH", repr(inp))
                     .replace("OUT_PATH", repr(outp))
                     .replace("EP_ARCHS", repr(EP_ARCHS)),
                     n_devices=EP_SHARDS, timeout=300)
    return arrays, dict(np.load(outp))


@pytest.mark.parametrize("name", EP_ARCHS)
def test_moe_mesh_forward_matches_reference(ep_reference, name):
    arrays, want = ep_reference
    params = {}
    for k, v in arrays.items():
        if k.startswith(f"{name}/p/"):
            node = params
            parts = k[len(f"{name}/p/"):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.from_numpy(v)
    tokens = torch.from_numpy(arrays[f"{name}/tokens"])
    mesh = VirtualMesh(EP_SHARDS, CPU, timeout=60)
    model = LMModel(REDUCED[name], moe_mesh=mesh, remat="none", device=CPU)
    calls = []
    orig = model._moe_sharded
    model._moe_sharded = lambda p, h: calls.append(h.shape) or orig(p, h)
    with torch.no_grad():
        logits, _, aux = model.forward(params, {"tokens": tokens})
        # the same model without the mesh: the one-device dispatch
        plain, _, plain_aux = LMModel(REDUCED[name], remat="none",
                                      device=CPU).forward(
            params, {"tokens": tokens})
    n_moe = REDUCED[name].n_layers - REDUCED[name].moe.n_dense_layers
    assert len(calls) == n_moe
    np.testing.assert_allclose(logits.numpy(), want[f"{name}/logits"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want[f"{name}/aux"]),
                               rtol=1e-5, atol=1e-9)
    # nothing drops at capacity factor 4 in either dispatch: the same
    # function as the one-device layer
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(plain_aux), rtol=1e-5)


def test_moe_mesh_needs_whole_blocks():
    arch = REDUCED["phi3.5-moe"]
    params = LMModel(arch, device=CPU).init_params(seed=0)
    tokens = torch.randint(1, arch.vocab_size, (1, 6), dtype=torch.int32)
    on = LMModel(arch, moe_mesh=VirtualMesh(EP_SHARDS, CPU, timeout=10),
                 device=CPU)
    with pytest.raises(ValueError, match="do not split into 4"):
        with torch.no_grad():
            on.forward(params, {"tokens": tokens})


def test_moe_mesh_decode_keeps_the_one_device_dispatch():
    """Decode never goes through the mesh, as the reference's: a model
    with ``moe_mesh`` decodes with the same bits as one without."""
    arch = REDUCED["phi3.5-moe"]
    plain = LMModel(arch, remat="none", device=CPU)
    meshed = LMModel(arch, remat="none", device=CPU,
                     moe_mesh=VirtualMesh(EP_SHARDS, CPU, timeout=10))
    meshed._moe_sharded = None          # a call through the mesh fails
    params = plain.init_params(seed=1)
    tok = torch.randint(1, arch.vocab_size, (2, 1), dtype=torch.int32)
    got, want = [], []
    for model, out in ((plain, want), (meshed, got)):
        cache = model.init_cache(2, 8)
        with torch.no_grad():
            for _ in range(3):
                logits, cache = model.decode_step(params, cache,
                                                  {"tokens": tok})[:2]
                out.append(logits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
