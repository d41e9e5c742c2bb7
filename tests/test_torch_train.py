"""The port's training path against the JAX reference on the CPU.

The same numpy inputs go through both packages: the loss, the schedules,
one AdamW update, the synthetic batches, the models' losses and gradients
(weights carried across with ``from_reference``), three train steps, the
accumulation path, checkpoints across packages, the fault-tolerance drill
and helpers, and the launcher. Tolerances: rtol 1e-6 for one loss or one
update (float32 round-off of the same operations), 1e-7 for the schedules,
bit for bit for data and checkpoints, 1e-5 for a reduced model's loss
and 1e-5 of each leaf's largest |grad| for its gradients (round-off
through 4 layers; 1e-4 for rwkv6-7b, see ``GRAD_REL``), 1e-4 for three
train steps (that round-off through
the optimizer), and parameters within 2 x the summed learning rates
(one Adam step moves a weight by at most ~lr).
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core import config as ref_config
from repro.core.params import init_params as ref_init
from repro.data import pipeline as ref_pipeline
from repro.launch import train as ref_launch
from repro.models import layers as ref_layers
from repro.models.lm import LMModel as RefLM
from repro.optim import adamw as ref_adamw
from repro.optim import schedules as ref_schedules
from repro.runtime import ft as ref_ft
from repro.runtime import train_loop as ref_train_loop
from repro_torch import checkpoint as ckpt
from repro_torch.configs.reduced import REDUCED
from repro_torch.core import config
from repro_torch.core.params import (abstract_params, axes_tree,
                                     from_reference, shapes_tree)
from repro_torch.data import pipeline
from repro_torch.launch import train as launch
from repro_torch.models import layers
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw, schedules
from repro_torch.runtime import ft, train_loop

CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)


def carry(tree):
    return from_reference(jax.tree.map(np.asarray, tree), CPU)


def t(x):
    return torch.from_numpy(np.asarray(x))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def ref_params(name):
    """The reference's float32 parameters of a reduced arch (drawn once a
    module: the reference's init takes seconds on the CPU)."""
    return ref_init(RefLM(REF_REDUCED[name], tp=1).schema(), KEY,
                    jnp.float32)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


# ---------------------------------------------------------------------------
# configs and the parameter schema
# ---------------------------------------------------------------------------
def test_run_configs_equal_the_reference():
    for name in ("StepKind", "ShapeConfig", "ShardingConfig", "TrainConfig",
                 "RunConfig"):
        port, ref = getattr(config, name), getattr(ref_config, name)
        if name == "StepKind":
            assert [m.value for m in port] == [m.value for m in ref]
            continue
        assert [f.name for f in dataclasses.fields(port)] == \
            [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(config.TrainConfig):
        assert getattr(config.TrainConfig(), f.name) == \
            getattr(ref_config.TrainConfig(), f.name)
    assert {k: (s.kind.value, s.seq_len, s.global_batch)
            for k, s in config.LM_SHAPES.items()} == \
        {k: (s.kind.value, s.seq_len, s.global_batch)
         for k, s in ref_config.LM_SHAPES.items()}
    arch = REDUCED["qwen2-0.5b"]
    run = config.RunConfig(arch=arch, shape=config.LM_SHAPES["train_4k"])
    ref = ref_config.RunConfig(arch=REF_REDUCED["qwen2-0.5b"],
                               shape=ref_config.LM_SHAPES["train_4k"])
    assert run.cache_key() == ref.cache_key()
    assert run.sharding.policy.value == ref.sharding.policy.value
    assert (run.param_dtype, run.activation_dtype) == \
        (ref.param_dtype, ref.activation_dtype)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-7b"])
def test_abstract_axes_and_shapes_trees_match_reference(name):
    from repro.core import params as ref_params
    schema = LMModel(REDUCED[name], device=CPU).schema()
    ref_schema = RefLM(REF_REDUCED[name], tp=1).schema()
    abstract = abstract_params(schema)
    ref_abstract = ref_params.abstract_params(ref_schema)
    got, want = flat(abstract), flat(ref_abstract)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape)
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype)
    assert flat(axes_tree(schema)) == flat(ref_params.axes_tree(ref_schema))
    assert flat(shapes_tree(schema)) == \
        flat(ref_params.shapes_tree(ref_schema))


# ---------------------------------------------------------------------------
# the loss, the schedules, one AdamW update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,z_loss,masked", [(100, 0.0, False),
                                                 (128, 1e-4, False),
                                                 (100, 1e-3, True)])
def test_cross_entropy_matches_reference(vocab, z_loss, masked):
    rng = np.random.RandomState(vocab)
    logits = (rng.randn(3, 7, 128) * 4).astype(np.float32)
    labels = rng.randint(0, vocab, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) > 0.3).astype(np.float32) if masked else None
    want = ref_layers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), vocab, z_loss,
        None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(t(logits), t(labels), vocab, z_loss,
                               None if mask is None else t(mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-6, atol=0)


def test_cross_entropy_of_bf16_logits_is_float32():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 64).astype(np.float32)
    labels = rng.randint(0, 60, (2, 5)).astype(np.int32)
    want = ref_layers.cross_entropy(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels), 60)
    got = layers.cross_entropy(t(logits).bfloat16(), t(labels), 60)
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), rtol=1e-6)


def test_schedules_match_reference():
    steps = np.arange(0, 1000, dtype=np.int32)
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000)
    want = ref_schedules.warmup_cosine(jnp.asarray(steps), **kw)
    got = schedules.warmup_cosine(t(steps), **kw)
    assert got.dtype == torch.float32
    # rtol 1e-7, which is less than one float32 ulp for part of the range:
    # torch's and XLA's cos differ in the last bit here and there, which
    # can flip the final rounding, so one ulp of the peak is allowed too
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-7,
                               atol=float(np.spacing(np.float32(3e-4))))
    np.testing.assert_array_equal(f32(got)[:100], f32(want)[:100])
    assert float(got[0]) == 0.0
    np.testing.assert_allclose(
        f32(schedules.constant(t(steps), peak_lr=0.1)),
        f32(ref_schedules.constant(jnp.asarray(steps), peak_lr=0.1)),
        rtol=1e-7)


def _opt_case(moment_dtype, grad_scale, master):
    rng = np.random.RandomState(int(grad_scale))
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    draw = lambda s: (rng.randn(*s)).astype(np.float32)  # noqa: E731
    params = jax.tree.map(lambda s: draw(s), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda p: draw(p.shape) * grad_scale, params)
    mu = jax.tree.map(lambda p: draw(p.shape) * 0.1, params)
    nu = jax.tree.map(lambda p: np.abs(draw(p.shape)) * 0.01, params)
    cfg = ref_config.TrainConfig(moment_dtype=moment_dtype,
                                 master_weights=master)
    md = jnp.dtype(moment_dtype)
    ref_state = ref_adamw.AdamWState(
        jnp.asarray(3, jnp.int32), jax.tree.map(lambda x: jnp.asarray(x, md),
                                                mu),
        jax.tree.map(lambda x: jnp.asarray(x, md), nu),
        jax.tree.map(jnp.asarray, params) if master else None)
    return params, grads, ref_state, cfg


@pytest.mark.parametrize("moment_dtype,grad_scale,master", [
    ("float32", 1.0, True), ("float32", 0.01, False),
    ("bfloat16", 1.0, True)])
def test_adamw_update_matches_reference(moment_dtype, grad_scale, master):
    params, grads, ref_state, ref_cfg = _opt_case(moment_dtype, grad_scale,
                                                  master)
    cfg = config.TrainConfig(moment_dtype=moment_dtype,
                             master_weights=master)
    lr = np.float32(2e-3)
    want_p, want_s, want_m = ref_adamw.update(
        jax.tree.map(jnp.asarray, grads), ref_state,
        jax.tree.map(jnp.asarray, params), jnp.asarray(lr), ref_cfg)
    state = adamw.AdamWState(
        t(np.int32(3)), carry(ref_state.mu), carry(ref_state.nu),
        carry(ref_state.master) if master else None)
    got_p, got_s, got_m = adamw.update(carry(grads), state, carry(params),
                                       t(lr), cfg)
    assert int(got_s.step) == 4 and got_s.step.dtype == torch.int32
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        for k, v in flat(got).items():
            assert v.dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[
                str(flat(want)[k].dtype)]
            np.testing.assert_allclose(f32(v), f32(flat(want)[k]),
                                       rtol=1e-6, atol=1e-12)
    assert (got_s.master is None) == (want_s.master is None)
    if master:
        for k, v in flat(got_s.master).items():
            np.testing.assert_allclose(f32(v), f32(flat(want_s.master)[k]),
                                       rtol=1e-6)
    for k in ("grad_norm", "clip"):
        np.testing.assert_allclose(f32(got_m[k]), f32(want_m[k]), rtol=1e-6)


def test_adamw_init_and_global_norm_match_reference():
    params, grads, _, _ = _opt_case("bfloat16", 2.0, True)
    want = ref_adamw.init(jax.tree.map(jnp.asarray, params),
                          ref_config.TrainConfig(moment_dtype="bfloat16"))
    got = adamw.init(carry(params), config.TrainConfig(
        moment_dtype="bfloat16"))
    assert got._fields == want._fields
    assert int(got.step) == 0 and got.step.dtype == torch.int32
    assert all(v.dtype == torch.bfloat16 and not v.any()
               for v in flat(got.mu).values())
    for k, v in flat(got.master).items():
        assert v.dtype == torch.float32 and torch.equal(v, t(flat(params)[k]))
    np.testing.assert_allclose(
        f32(adamw.global_norm(carry(grads))),
        f32(ref_adamw.global_norm(jax.tree.map(jnp.asarray, grads))),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen2-vl-2b",
                                  "musicgen-large"])
def test_synth_batch_is_the_references_bits(name):
    for step, seed, host in ((0, 0, 0), (7, 3, 1)):
        want = ref_pipeline.synth_batch(REF_REDUCED[name], 3, 24, step=step,
                                        seed=seed, host_id=host)
        got = pipeline.synth_batch(REDUCED[name], 3, 24, step=step,
                                   seed=seed, host_id=host)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    loader = pipeline.PrefetchingLoader(REDUCED[name], 2, 24, seed=5,
                                        start_step=4)
    try:
        for step in range(4, 7):
            b = next(loader)
            want = ref_pipeline.synth_batch(REF_REDUCED[name], 2, 24,
                                            step=step, seed=5)
            for k in want:
                np.testing.assert_array_equal(b[k], want[k])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


# ---------------------------------------------------------------------------
# the models' losses and gradients
# ---------------------------------------------------------------------------
def _batch(name, B=2, S=16, step=0):
    return ref_pipeline.synth_batch(REF_REDUCED[name], B, S, step=step)


# Each leaf's grads within GRAD_REL of its largest |grad|. rwkv6-7b's
# gradients move by 6.6e-5 of their largest value when its weights move
# by 1e-7 (one float32 rounding; its time mix's group norm magnifies it),
# while its loss agrees within 1e-7, so its bound is 1e-4; the other two
# move by 1.5e-6 and 3.0e-6 and are held to 1e-5.
GRAD_REL = {"qwen2-0.5b": 1e-5, "recurrentgemma-2b": 1e-5, "rwkv6-7b": 1e-4}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "recurrentgemma-2b",
                                  "rwkv6-7b"])
def test_loss_and_grads_match_reference(name):
    arch = REF_REDUCED[name]
    # the reference's WKV6 Pallas body does not run in interpret mode on
    # this jax; its plain path defines the numbers
    ref = RefLM(arch, tp=1, remat="block",
                kernel_mode="ref" if name == "rwkv6-7b" else None)
    params = ref_params(name)
    nb = _batch(name)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss_fn(p, b, z_loss=1e-4), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in nb.items()})
    batch = {k: t(v) for k, v in nb.items()}
    grads = {}
    for remat in ("block", "none"):
        model = LMModel(REDUCED[name], remat=remat, device=CPU)
        p = carry(params)
        for k, v in flat(p).items():
            v.requires_grad_()
        loss, m = model.loss_fn(p, batch, z_loss=1e-4)
        np.testing.assert_allclose(f32(loss), f32(want), rtol=1e-5)
        for k in ("ce", "aux", "z"):
            np.testing.assert_allclose(f32(m[k]), f32(want_m[k]), rtol=1e-5,
                                       atol=1e-7)
        loss.backward()
        grads[remat] = {k: v.grad for k, v in flat(p).items()}
    ref_g = flat(want_g)
    assert grads["block"].keys() == ref_g.keys()
    for k, g in grads["block"].items():
        w = f32(ref_g[k])
        top = float(np.abs(w).max())
        err = float(np.abs(f32(g) - w).max())
        assert err <= GRAD_REL[name] * top, (k, err, top)
        # the recompute gives the same bits as the pass that kept all
        assert torch.equal(g, grads["none"][k]), k


def test_block_remat_recomputes_each_stacked_unit():
    """Under remat="block" the kernels' wrappers run again in the
    backward for each stacked unit (not for the tail), as the reference's
    checkpointed scan body does; with "none" they run once."""
    from repro_torch.models import attention, rglru
    arch = REDUCED["recurrentgemma-2b"]
    params = carry(ref_params("recurrentgemma-2b"))
    batch = {k: t(v) for k, v in _batch("recurrentgemma-2b").items()}
    counts = {}
    for remat in ("block", "none"):
        calls = {"attn": 0, "scan": 0}
        orig = attention.flash_attention, rglru.linear_scan

        def fa(*a, **k):
            calls["attn"] += 1
            return orig[0](*a, **k)

        def sc(*a, **k):
            calls["scan"] += 1
            return orig[1](*a, **k)
        attention.flash_attention, rglru.linear_scan = fa, sc
        try:
            p = {k: v for k, v in params.items()}
            leaves = [v.detach().requires_grad_() for v in flat(p).values()]
            rebuilt = train_loop._build(
                [tuple(k.split("/")) for k in flat(p)], leaves)
            loss, _ = LMModel(arch, remat=remat, device=CPU).loss_fn(
                rebuilt, batch)
            torch.autograd.grad(loss, leaves)
        finally:
            attention.flash_attention, rglru.linear_scan = orig
        counts[remat] = calls
    # one super-block (rglru, rglru, local_attn) and one tail rglru
    assert counts["none"] == {"attn": 1, "scan": 3}
    assert counts["block"] == {"attn": 2, "scan": 5}


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def _step_setup(name, accum, lr=1e-3, warmup=2):
    arch = REF_REDUCED[name]
    ref_model = RefLM(arch, tp=1, remat="block")
    model = LMModel(REDUCED[name], remat="block", device=CPU)
    train_kw = dict(learning_rate=lr, warmup_steps=warmup, accum_steps=accum)
    ref_cfg = ref_config.RunConfig(arch=arch,
                                   shape=ref_config.LM_SHAPES["train_4k"],
                                   train=ref_config.TrainConfig(**train_kw))
    cfg = config.RunConfig(arch=REDUCED[name],
                           shape=config.LM_SHAPES["train_4k"],
                           train=config.TrainConfig(**train_kw))
    return ref_model, model, ref_cfg, cfg, ref_params(name)


def _run_steps(name, accum, n_steps=3, B=4):
    ref_model, model, ref_cfg, cfg, params = _step_setup(name, accum)
    ref_step = jax.jit(ref_train_loop.make_train_step(ref_model, ref_cfg,
                                                      total_steps=n_steps))
    step_fn = train_loop.make_train_step(model, cfg, total_steps=n_steps)
    rp, rs = params, ref_adamw.init(params, ref_cfg.train)
    pp = carry(params)
    ps = adamw.init(pp, cfg.train)
    start = {k: v.clone() for k, v in flat(pp).items()}
    out = []
    for step in range(n_steps):
        nb = _batch(name, B=B, step=step)
        rp, rs, rm = ref_step(rp, rs, {k: jnp.asarray(v)
                                       for k, v in nb.items()},
                              jnp.asarray(step))
        pp, ps, pm = step_fn(pp, ps, {k: t(v) for k, v in nb.items()}, step)
        out.append((rm, pm))
    return out, rp, rs, pp, ps, start


def test_three_train_steps_match_reference():
    out, rp, rs, pp, ps, start = _run_steps("recurrentgemma-2b", accum=1)
    lrs = 0.0
    for rm, pm in out:
        for k in ("loss", "grad_norm", "lr", "clip"):
            np.testing.assert_allclose(f32(pm[k]), f32(rm[k]), rtol=1e-4)
        np.testing.assert_allclose(f32(pm["ce"]), f32(rm["ce"]), rtol=1e-4)
        lrs += float(rm["lr"])
    assert float(out[0][1]["lr"]) == 0.0
    assert int(ps.step) == int(rs.step) == 3
    for k, v in flat(pp).items():
        want = f32(flat(rp)[k])
        assert float(np.abs(f32(v) - want).max()) <= 2 * lrs, k
        np.testing.assert_allclose(f32(flat(ps.master)[k]),
                                   f32(flat(rs.master)[k]), atol=2 * lrs)
        # the parameters moved, and stayed equal to the master copy
        assert torch.equal(v, flat(ps.master)[k])
    assert any(not torch.equal(v, start[k]) for k, v in flat(pp).items())


def test_step_zero_leaves_the_master_weights():
    _, model, _, cfg, params = _step_setup("qwen2-0.5b", accum=1)
    pp = carry(params)
    ps = adamw.init(pp, cfg.train)
    before = {k: v.clone() for k, v in flat(ps.master).items()}
    step_fn = train_loop.make_train_step(model, cfg, total_steps=3)
    pp, ps, m = step_fn(pp, ps, {k: t(v) for k, v in
                                 _batch("qwen2-0.5b").items()}, 0)
    assert float(m["lr"]) == 0.0 and float(m["grad_norm"]) > 0
    for k, v in flat(ps.master).items():
        assert torch.equal(v, before[k]), k
    assert any(v.any() for v in flat(ps.mu).values())


def test_accumulation_matches_reference_and_casts_to_bf16(monkeypatch):
    seen = []
    orig = adamw.update

    def spy(grads, *a, **k):
        seen.append({v.dtype for v in flat(grads).values()})
        return orig(grads, *a, **k)
    monkeypatch.setattr(train_loop.adamw, "update", spy)
    out, rp, rs, pp, ps, _ = _run_steps("qwen2-0.5b", accum=2, n_steps=2)
    assert seen == [{torch.bfloat16}] * 2
    lrs = 0.0
    for rm, pm in out:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(f32(pm[k]), f32(rm[k]), rtol=1e-4)
        assert "ce" not in pm and "ce" not in rm
        lrs += float(rm["lr"])
    for k, v in flat(pp).items():
        assert float(np.abs(f32(v) - f32(flat(rp)[k])).max()) <= 2 * lrs


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _ckpt_tree(master):
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "blocks": {"h": rng.randn(2, 5).astype(np.float32),
                         "b": rng.randn(6).astype(np.float32)}}
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_params["blocks"]["b"] = ref_params["blocks"]["b"].astype(jnp.bfloat16)
    ref_state = ref_adamw.init(ref_params, ref_config.TrainConfig(
        master_weights=master, moment_dtype="bfloat16"))
    ref_state = ref_state._replace(step=jnp.asarray(7, jnp.int32))
    return ref_params, ref_state


def _same_bits(got, want):
    got, want = ckpt.checkpoint._flatten(got), \
        ref_ckpt.checkpoint._flatten(want)
    assert got.keys() == want.keys()
    for k, v in got.items():
        if v is None:
            assert want[k] is None
            continue
        w = want[k]
        assert str(v.dtype).removeprefix("torch.") == str(w.dtype), k
        assert tuple(v.shape) == tuple(w.shape), k
        np.testing.assert_array_equal(f32(v), f32(w))


@pytest.mark.parametrize("master", [True, False])
def test_checkpoints_interchange_with_reference(tmp_path, master):
    ref_params, ref_state = _ckpt_tree(master)
    tree_ref = (ref_params, ref_state)
    tree = (carry(ref_params), adamw.AdamWState(
        t(np.asarray(ref_state.step)), carry(ref_state.mu),
        carry(ref_state.nu),
        carry(ref_state.master) if master else None))
    # the reference writes, the port reads; and the other way round
    ref_ckpt.save(str(tmp_path / "ref"), 7, tree_ref)
    _same_bits(ckpt.restore(str(tmp_path / "ref"), 7, tree), tree_ref)
    ckpt.save(str(tmp_path / "port"), 7, tree)
    _same_bits(tree, ref_ckpt.restore(str(tmp_path / "port"), 7, tree_ref))
    # the same files, shapes and recorded dtypes
    idx = [json.loads((tmp_path / d / "step_00000007" / "index.json")
                      .read_text()) for d in ("ref", "port")]
    assert idx[0] == idx[1]
    restored = ckpt.restore(str(tmp_path / "ref"), 7, tree)
    assert isinstance(restored[1], adamw.AdamWState)
    assert restored[0]["blocks"]["b"].dtype == torch.bfloat16


def test_checkpoint_commit_retention_and_async(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2)}}
    os_tmp = tmp_path / "step_00000009.tmp"
    os_tmp.mkdir()
    ckpt.save(d, 1, tree)
    (tmp_path / "step_00000005").mkdir()           # never committed
    assert ckpt.latest_step(d) == ref_ckpt.latest_step(d) == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 5, tree)
    mgr = ckpt.CheckpointManager(d, keep=2)
    for s in (2, 3, 4):
        mgr.save_async(s, {"a": tree["a"] + s, "b": tree["b"]})
    mgr.wait()
    assert mgr.saved_steps == [2, 3, 4]
    # the reference's retention counts the uncommitted step 5 too
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if not p.name.endswith(".tmp"))
    assert kept == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(d) == 4
    got = ckpt.restore(d, 4, tree)
    assert torch.equal(got["a"], tree["a"] + 4)


def test_async_checkpoint_snapshots_before_in_place_updates(tmp_path,
                                                            monkeypatch):
    """save_async takes its copy on the caller's thread: leaves that the
    optimizer then updates in place (as adamw.update does) before the
    background write runs are saved with the values they had at the
    call. The write is held back until after the update, so the test
    does not depend on the thread's timing."""
    import threading
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    gate = threading.Event()
    real_save = ckpt_mod.save

    def held_save(*args, **kw):
        assert gate.wait(30)
        return real_save(*args, **kw)

    monkeypatch.setattr(ckpt_mod, "save", held_save)
    tree = {"a": torch.arange(6.0), "b": torch.full((3,), 1.5,
                                                    dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in tree.items()}
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(1, tree)
    tree["a"].mul_(-3.0).add_(7.0)
    tree["b"].copy_(torch.zeros(3))
    gate.set()
    mgr.wait()
    got = ckpt.restore(str(tmp_path), 1, tree)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def test_ft_drill_matches_reference(tmp_path):
    name = "qwen2-0.5b"
    kw = dict(n_steps=8, batch=2, seq=16, ckpt_every=2)
    model = LMModel(REDUCED[name], remat="none", device=CPU)
    cfg = config.RunConfig(arch=REDUCED[name],
                           shape=config.LM_SHAPES["train_4k"],
                           train=config.TrainConfig(warmup_steps=2))
    res = train_loop.train(model, cfg, ckpt_dir=str(tmp_path / "port"),
                           injector=ft.FailureInjector(fail_at_steps=[5]),
                           **kw)
    clean = train_loop.train(model, cfg, n_steps=8, batch=2, seq=16)
    ref_model = RefLM(REF_REDUCED[name], tp=1, remat="none")
    ref_cfg = ref_config.RunConfig(arch=REF_REDUCED[name],
                                   shape=ref_config.LM_SHAPES["train_4k"],
                                   train=ref_config.TrainConfig(
                                       warmup_steps=2))
    want = ref_train_loop.train(
        ref_model, ref_cfg, ckpt_dir=str(tmp_path / "ref"),
        injector=ref_ft.FailureInjector(fail_at_steps=[5]), **kw)
    assert (res.restarts, res.steps_run, len(res.losses)) == \
        (want.restarts, want.steps_run, len(want.losses)) == (1, 8, 9)
    # the restart resumed from step 4's checkpoint: steps 4 and 5 again
    assert res.losses[4] == res.losses[5]
    np.testing.assert_allclose(res.final_loss, clean.final_loss, rtol=1e-6)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_straggler_and_elastic_helpers_match_reference():
    rng = np.random.RandomState(0)
    times = rng.uniform(0.8, 1.2, (6, 5))
    times[:, 2] *= 3
    dets = [ft.StragglerDetector(n_hosts=5, warmup=2, threshold=1.4),
            ref_ft.StragglerDetector(n_hosts=5, warmup=2, threshold=1.4)]
    for row in times:
        for h, s in enumerate(row):
            for d in dets:
                d.record(h, float(s))
    got, want = (d.stragglers() for d in dets)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want] and [s.host for s in got] == [2]
    np.testing.assert_array_equal(dets[0].data_shares(),
                                  dets[1].data_shares())
    for n, mp in ((256, 16), (240, 16), (7, 2)):
        assert ft.elastic_mesh_shape(n, mp) == ref_ft.elastic_mesh_shape(n, mp)
    for mod in (ft, ref_ft):
        with pytest.raises(ValueError):
            mod.elastic_mesh_shape(8, 16)
    assert ft.surviving_devices(list(range(256)), 16) == \
        ref_ft.surviving_devices(list(range(256)), 16)
    inj = ft.FailureInjector(fail_at_steps=[3])
    inj.check(2)
    with pytest.raises(ft.SimulatedFailure):
        inj.check(3)
    inj.check(3)                                   # fires once


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_prints_the_references_keys(monkeypatch):
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "8"]
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with contextlib.redirect_stdout(buf):
        ref_launch.main()
    want = json.loads(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = launch.main(argv + ["--device", "cpu"])
    assert json.loads(buf.getvalue()) == got
    assert got.keys() == want.keys()
    assert (got["arch"], got["steps"], got["restarts"]) == \
        (want["arch"], want["steps"], want["restarts"])
    assert np.isfinite(got["final_loss"])


def test_launcher_loss_falls_and_needs_a_card_by_default():
    """The reference's own check (tests/test_runtime.py): reduced
    qwen2-0.5b at lr 3e-3 for 12 steps of 4 x 16 tokens."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = launch.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                           "12", "--batch", "4", "--seq", "16", "--lr",
                           "3e-3", "--device", "cpu"])
    assert got["steps"] == 12 and got["final_loss"] < got["first_loss"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                         "1"])


def test_training_modules_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.optim, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.runtime.train_loop, "
            "repro_torch.runtime.ft, repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
