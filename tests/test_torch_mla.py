"""The port's MLA blocks and the deepseek-v3 layer plan (MLA + MoE with 3
leading dense layers and a shared expert + the MTP head) against the JAX
reference on the CPU, and ``cache_axes`` of every reduced config.

Weights come from the reference's ``init_params`` (carried across with
``from_reference``); inputs and tokens from numpy seeds. The reference
runs its flash attention in interpret mode in the module tests (as
tests/test_torch_lm.py) and in the mode its own model tests use on the
CPU (the chunked plain version) in the model tests. Tolerances are those
of tests/test_torch_lm.py and tests/test_torch_moe.py: 1e-5 for one
module (float32 round-off of the same products summed in other orders),
1e-4 for a reduced model's logits, 2e-3 for the absorbed decode against
the expanded forward (the reference's own bound for decode against
forward, tests/test_models_parity.py: the absorbed form multiplies in
another order, q through wk_b before the latent), each gradient leaf
within 1e-5 of its largest |grad|, and the losses within 1e-5 relative.
"""
import contextlib
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core.params import init_params as ref_init
from repro.launch import serve as ref_serve
from repro.models import attention as ref_attn
from repro.models.lm import LMModel as RefLM
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.reduced import REDUCED
from repro_torch.core.config import PaddedDims
from repro_torch.core.params import from_reference, param_count
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention
from repro_torch.models.lm import LMModel

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
GRAD_REL = 1e-5          # each leaf's grads, of its largest |grad|
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
DS = "deepseek-v3"
B = 2


def carry(tree):
    return from_reference(jax.tree.map(np.asarray, tree), CPU)


def t(x):
    return torch.from_numpy(np.array(x))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _tokens(seed, S):
    rng = np.random.RandomState(seed)
    return rng.randint(1, REDUCED[DS].vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the MLA block
# ---------------------------------------------------------------------------
def _mla_params():
    arch = REF_REDUCED[DS]
    padded = PaddedDims.for_tp(REDUCED[DS], 1)
    p = ref_init(ref_attn.mla_schema(arch, padded), KEY, jnp.float32)
    # norms off 1, so their weights are exercised
    r = arch.mla.kv_lora_rank
    p = dict(p, q_a_norm=1 + p["wq_a"][0] * 3,
             kv_a_norm=1 - p["wkv_a"][1, :r] * 3)
    return arch, p, carry(p)


def test_mla_schema_is_the_references():
    arch, p, tp = _mla_params()
    schema = attention.mla_schema(REDUCED[DS],
                                  PaddedDims.for_tp(REDUCED[DS], 1))
    assert set(schema) == set(p)
    for k, d in schema.items():
        assert d.shape == p[k].shape, k
    m = arch.mla
    assert schema["wq_b"].shape == (m.q_lora_rank, 4, 16 + 8)
    assert schema["wkv_a"].shape == (arch.d_model, m.kv_lora_rank + 8)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mla_forward_and_decode_match_reference(cache_dtype):
    """The expanded forward, then decode step by step. A float32 cache runs
    free; a bfloat16 cache is taken from the reference's at every step (a
    latent entry may round to the neighbouring bfloat16 value in either
    package), and the entry written is held within one bfloat16 step."""
    arch, p, tp = _mla_params()
    steps = 11
    x = np.random.RandomState(2).randn(B, steps, arch.d_model)
    x = x.astype(np.float32)
    close(attention.mla_forward(tp, t(x), REDUCED[DS],
                                positions=torch.arange(steps)),
          ref_attn.mla_forward(p, jnp.asarray(x), arch,
                               positions=jnp.arange(steps),
                               kernel_mode="interpret"), MODULE_TOL)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[cache_dtype]
    ref_cache = ref_attn.mla_init_cache(arch, B, steps + 3, jdt)
    cache = attention.mla_init_cache(REDUCED[DS], B, steps + 3,
                                     getattr(torch, cache_dtype))
    assert tuple(cache["latent"].shape) == ref_cache["latent"].shape
    for step in range(steps):
        if cache_dtype == "bfloat16":
            cache = carry(ref_cache)
        xs = x[:, step:step + 1]
        length = np.full((B,), step, np.int32)
        want, ref_cache = ref_attn.mla_decode(
            p, jnp.asarray(xs), ref_cache, jnp.asarray(length), arch)
        got, cache = attention.mla_decode(tp, t(xs), cache, t(length),
                                          REDUCED[DS])
        close(got, want, MODULE_TOL)
        assert cache["latent"].dtype == getattr(torch, cache_dtype)
        a, b = f32(cache["latent"]), f32(ref_cache["latent"])
        one_step = np.abs(b) * 2.0 ** -7 if cache_dtype == "bfloat16" else 0
        assert (np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b) + one_step).all()


def test_mla_absorbed_decode_matches_expanded_forward():
    """Within the port: the latent-space decode against the per-head
    forward over the same inputs, and the entry lands at lane 0's slot."""
    _, _, tp = _mla_params()
    arch = REDUCED[DS]
    steps = 13
    x = t(np.random.RandomState(3).randn(B, steps, arch.d_model)
          .astype(np.float32))
    full = attention.mla_forward(tp, x, arch, positions=torch.arange(steps))
    cache = attention.mla_init_cache(arch, B, steps + 1, torch.float32)
    for step in range(steps):
        got, cache = attention.mla_decode(tp, x[:, step:step + 1], cache,
                                          torch.full((B,), step), arch)
        close(got[:, 0], full[:, step], DECODE_TOL)
    written = cache["latent"].abs().sum(dim=-1) > 0
    assert written[:, :steps].all() and not written[:, steps:].any()


# ---------------------------------------------------------------------------
# deepseek-v3, reduced: 3 dense layers, 1 MoE layer, the MTP head
# ---------------------------------------------------------------------------
def test_deepseek_forward_loss_and_grads_match_reference():
    ref_model = RefLM(REF_REDUCED[DS], remat="block")
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    model = LMModel(REDUCED[DS], device="cpu")
    p = carry(ref_p)
    assert p["dense_blocks"]["attn"]["wkv_a"].shape[0] == 3
    assert p["blocks"]["moe"]["shared_up"].shape[0] == 1
    ids = _tokens(3, 13)
    nb = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    want, _, want_aux = jax.jit(ref_model.forward)(ref_p, jb)
    got, _, aux = model.forward(p, {"tokens": t(nb["tokens"])})
    close(got, want, MODEL_TOL)
    close(aux, want_aux, dict(rtol=1e-5, atol=1e-9))
    assert float(aux) > 0
    last, _ = model.prefill(p, {"tokens": t(nb["tokens"])})
    close(last, got[:, -1:], MODULE_TOL)

    (want_l, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(p, b, z_loss=1e-4), has_aux=True))(
        ref_p, jb)
    flat = _flat(p)
    for v in flat.values():
        v.requires_grad_()
    loss, m = model.loss_fn(p, {k: t(v) for k, v in nb.items()},
                            z_loss=1e-4)
    assert set(m) == set(want_m) == {"ce", "aux", "z", "mtp"}
    np.testing.assert_allclose(f32(loss), f32(want_l), rtol=1e-5)
    for k in ("ce", "aux", "z", "mtp"):
        np.testing.assert_allclose(f32(m[k]), f32(want_m[k]), rtol=1e-5,
                                   atol=1e-9)
    np.testing.assert_allclose(
        f32(loss), f32(m["ce"] + m["aux"] + 0.3 * m["mtp"]), rtol=1e-6)
    loss.backward()
    ref_g = _flat(jax.tree.map(np.asarray, want_g))
    assert flat.keys() == ref_g.keys()
    assert {"mtp/proj", "mtp/layer/attn/wk_b", "mtp/layer/mlp/w_up"} \
        <= flat.keys()
    for k, v in flat.items():
        top = float(np.abs(ref_g[k]).max())
        err = float(np.abs(f32(v.grad) - ref_g[k]).max())
        assert top > 0 and err <= GRAD_REL * top, (k, err, top)


def test_deepseek_decode_matches_reference_and_forward():
    """Decode from an empty float32 cache against the reference's decode,
    and against the port's forward (the reduced capacity factor, 4, is
    above n_experts / top_k = 2: no assignment drops)."""
    ref_model = RefLM(REF_REDUCED[DS], remat="none", cache_dtype=jnp.float32)
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    model = LMModel(REDUCED[DS], device="cpu", cache_dtype=torch.float32)
    p = carry(ref_p)
    S = 10
    ids = _tokens(5, S)
    full, _, _ = model.forward(p, {"tokens": t(ids)})
    ref_cache = ref_model.init_cache(B, S + 2)
    cache = model.init_cache(B, S + 2)
    assert _flat(cache).keys() == _flat(ref_cache).keys()
    ref_step = jax.jit(ref_model.decode_step)
    for step in range(S):
        col = ids[:, step:step + 1]
        want, ref_cache = ref_step(ref_p, ref_cache,
                                   {"tokens": jnp.asarray(col)})
        got, cache = model.decode_step(p, cache, {"tokens": t(col)})
        close(got, want, MODEL_TOL)
        close(got[:, 0], full[:, step], DECODE_TOL)
    assert cache["len"].tolist() == [S] * B
    jax.tree.map(lambda a, b: close(a, b, MODEL_TOL), cache,
                 carry(ref_cache))


def test_from_reference_and_init_params_carry_the_mtp_and_mla_leaves():
    """Every leaf of the reference's parameter and cache trees lands in the
    port's layout; the port's own draw has the same leaves, shapes and
    scales (other bits)."""
    ref_model = RefLM(REF_REDUCED[DS], remat="none")
    ref_p = jax.tree.map(np.asarray, ref_init(ref_model.schema(), KEY,
                                              jnp.float32))
    model = LMModel(REDUCED[DS], device="cpu")
    flat_ref = _flat(ref_p)
    got = _flat(from_reference(ref_p, CPU))
    schema = _flat(model.schema())
    assert got.keys() == flat_ref.keys() == schema.keys()
    assert param_count(model.schema()) == sum(v.size for v in
                                              flat_ref.values())
    for path, v in got.items():
        np.testing.assert_array_equal(v.numpy(), flat_ref[path])
    for leaf in ("mtp/proj", "mtp/norm_h", "mtp/norm_e",
                 "mtp/layer/attn/wq_a", "mtp/layer/attn/wv_b",
                 "dense_blocks/attn/kv_a_norm", "blocks/attn/wkv_a",
                 "blocks/moe/shared_gate"):
        assert leaf in got
    mine = _flat(model.init_params(seed=0))
    assert mine.keys() == flat_ref.keys()
    for path, v in mine.items():
        ref = flat_ref[path]
        assert tuple(v.shape) == ref.shape and v.dtype == torch.float32
        if ref.std() == 0:                      # zeros / ones
            np.testing.assert_array_equal(v.numpy(), ref)
        elif ref.size >= 1024:                  # same scale, other bits
            assert abs(float(v.std()) / float(ref.std()) - 1) < 0.1, path
    ref_cache = _flat(jax.tree.map(np.asarray, ref_model.init_cache(B, 8)))
    cache = _flat(model.init_cache(B, 8))
    assert cache.keys() == ref_cache.keys()
    for path, v in cache.items():
        assert tuple(v.shape) == ref_cache[path].shape, path
        assert str(v.dtype).split(".")[-1] == ref_cache[path].dtype.name


def test_full_deepseek_depth_cut_counts_its_parameters():
    """The card's cut (4 of 61 layers at full width, the MTP head): the
    schema alone, no weights."""
    arch = dataclasses.replace(get_arch(DS), n_layers=4)
    model = LMModel(arch, device="cpu")
    s = model.schema()
    assert param_count(s) == 15_797_359_616            # 58.85 GiB in fp32
    assert s["blocks"]["moe"]["w_gate"].shape == (1, 256, 7168, 2048)
    assert s["dense_blocks"]["mlp"]["w_up"].shape == (3, 7168, 18432)
    assert s["mtp"]["layer"]["mlp"]["w_up"].shape == (7168, 18432)
    assert s["blocks"]["attn"]["wq_b"].shape == (1, 1536, 128, 192)
    assert model.cache_spec(8, 128)["blocks"]["latent"] == (
        (1, 8, 128, 576), torch.bfloat16)


SERVE_ARGS = ["--arch", DS, "--reduced", "--requests", "5",
              "--wave-slots", "3", "--max-new", "4", "--n-pages", "8"]


def test_serve_launcher_matches_reference(monkeypatch):
    made = []

    class Recording(ref_serve.ContinuousBatcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(ref_serve, "ContinuousBatcher", Recording)
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE_ARGS)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_serve.main()
    want = json.loads(buf.getvalue())
    assert want["completed"] == 5
    stats, batcher = port_serve.serve(
        port_serve.parse_args(SERVE_ARGS + ["--device", "cpu"]),
        params=carry(made[0].params))
    assert stats == want

    def close_cache(mine, ref):
        # the bf16 latent: one bfloat16 step of slack (test_torch_lm.py)
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        a, b = f32(mine), f32(ref)
        step = np.abs(b) * 2.0 ** -7 if mine.dtype == torch.bfloat16 else 0
        assert (np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(b) + step).all()

    jax.tree.map(close_cache, batcher.cache, carry(made[0].cache))


# ---------------------------------------------------------------------------
# every config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(ARCHS))
def test_cache_axes_and_spec_match_reference(name):
    """``cache_axes`` equals the reference's for every reduced config, and
    names each leaf of ``cache_spec`` (shapes and dtypes the reference's)
    with one axis a dimension."""
    ref_model = RefLM(REF_REDUCED[name], remat="none")
    model = LMModel(REDUCED[name], device="cpu")
    axes = model.cache_axes()
    assert axes == ref_model.cache_axes()
    spec = _flat(model.cache_spec(B, 16))
    ref_spec = _flat(ref_model.cache_spec(B, 16))
    flat_axes = _flat(axes)
    assert spec.keys() == ref_spec.keys() == flat_axes.keys()
    for k, (shape, dt) in spec.items():
        assert shape == ref_spec[k].shape, k
        assert str(dt).split(".")[-1] == ref_spec[k].dtype.name, k
        assert len(flat_axes[k]) == len(shape), k
