"""The port's audio and vlm plans (musicgen-large, qwen2-vl-2b), M-RoPE,
the codebook serving wave and ``from_reference`` on the moe, audio and vlm
trees, against the JAX reference on the CPU.

Weights come from the reference's ``init_params`` (carried across with
``from_reference``); batches from the reference's ``synth_batch`` (frame
embeddings for audio; patch embeddings, 3-D patch positions and text for
vlm). Tolerances are those of tests/test_torch_lm.py: 1e-5 for one module,
1e-4 for a reduced model, 2e-3 for decode against forward, and each
gradient leaf within 1e-5 of its largest |grad| (tests/test_torch_train.py).
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
from repro.data.pipeline import synth_batch
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models.lm import LMModel as RefLM
from repro_torch.configs.reduced import REDUCED
from repro_torch.core.params import from_reference, param_count
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers
from repro_torch.models.lm import LMModel

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
GRAD_REL = 1e-5          # each leaf's grads, of its largest |grad|
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
VLM, AUDIO = "qwen2-vl-2b", "musicgen-large"
B, S = 2, 16


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


def _pair(name, **kw):
    ref_model = RefLM(REF_REDUCED[name], remat="none", **kw)
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    return ref_model, ref_p, LMModel(REDUCED[name], device="cpu"), \
        carry(ref_p)


@pytest.mark.parametrize("sections", [(1, 1, 2), (2, 1, 1)])
def test_apply_mrope_matches_reference(sections):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 3, 16).astype(np.float32) * 3
    pos = rng.randint(0, 50, (2, 9, 3)).astype(np.int32)
    got = layers.apply_mrope(t(x), t(pos), 1e6, sections)
    close(got, ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                      sections), MODULE_TOL)
    # one position in all three streams is plain RoPE
    same = np.repeat(pos[..., :1], 3, axis=-1)
    close(layers.apply_mrope(t(x), t(same), 1e6, sections),
          layers.apply_rope(t(x), t(pos[..., 0]), 1e6), MODULE_TOL)


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_forward_prefill_loss_and_grads_match_reference(name):
    ref_model, ref_p, model, p = _pair(name)
    nb = synth_batch(REF_REDUCED[name], B, S, step=1, seed=2)
    if name == VLM:
        assert nb["patch_embeds"].shape == (B, 8, 64)
        assert nb["tokens"].shape == nb["labels"].shape == (B, S - 8)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    batch = {k: t(v) for k, v in nb.items()}
    want, _, _ = jax.jit(ref_model.forward)(ref_p, jb)
    got, _, aux = model.forward(p, batch)
    assert got.shape == want.shape
    close(got, want, MODEL_TOL)
    assert float(aux) == 0.0
    last, _ = model.prefill(p, batch)
    close(last, got[:, -1:], MODULE_TOL)
    (want_l, want_m), want_g = jax.jit(jax.value_and_grad(
        ref_model.loss_fn, has_aux=True))(ref_p, jb)
    flat = _flat(p)
    for v in flat.values():
        v.requires_grad_()
    loss, m = model.loss_fn(p, batch)
    np.testing.assert_allclose(f32(loss), f32(want_l), rtol=1e-5)
    np.testing.assert_allclose(f32(m["ce"]), f32(want_m["ce"]), rtol=1e-5)
    loss.backward()
    ref_g = _flat(jax.tree.map(np.asarray, want_g))
    assert flat.keys() == ref_g.keys()
    for k, v in flat.items():
        # audio's codebook embeddings are not on the forward path: no grad
        g = v.grad if v.grad is not None else torch.zeros_like(v)
        top = float(np.abs(ref_g[k]).max())
        err = float(np.abs(f32(g) - ref_g[k]).max())
        assert err <= GRAD_REL * top, (k, err, top)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_vlm_positions_are_the_patches_then_the_text():
    model = LMModel(REDUCED[VLM], device="cpu")
    nb = synth_batch(REF_REDUCED[VLM], B, S, step=0)
    pos = model._positions({k: t(v) for k, v in nb.items()}, S, CPU)
    assert pos.shape == (B, S, 3)
    np.testing.assert_array_equal(pos[:, :8].numpy(), nb["patch_pos"])
    text = 8 + np.arange(S - 8)
    np.testing.assert_array_equal(pos[:, 8:].numpy(),
                                  np.broadcast_to(text[None, :, None],
                                                  (B, S - 8, 3)))


def _decode_batches(name, nb, step):
    if name == AUDIO:
        return {"embeds": nb["embeds"][:, step:step + 1]}
    return {"tokens": nb["tokens"][:, step:step + 1]}


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_decode_matches_reference_and_forward(name):
    """Decode from an empty float32 cache against the reference's decode,
    and against the port's forward over the same inputs (text only for
    vlm, frame embeddings one at a time for audio)."""
    ref_model, ref_p, _, p = _pair(name, cache_dtype=jnp.float32)
    model = LMModel(REDUCED[name], device="cpu", cache_dtype=torch.float32)
    steps = 10
    nb = synth_batch(REF_REDUCED[name], B, steps, step=3, seed=4)
    if name == VLM:
        nb = {"tokens": nb["tokens"]}
        rng = np.random.RandomState(6)
        nb["tokens"] = rng.randint(1, REDUCED[name].vocab_size,
                                   (B, steps)).astype(np.int32)
    full, _, _ = model.forward(p, {k: t(v) for k, v in nb.items()})
    ref_cache = ref_model.init_cache(B, steps + 2)
    cache = model.init_cache(B, steps + 2)
    ref_step = jax.jit(ref_model.decode_step)
    for step in range(steps):
        inp = _decode_batches(name, nb, step)
        want, ref_cache = ref_step(ref_p, ref_cache,
                                   {k: jnp.asarray(v) for k, v in inp.items()})
        got, cache = model.decode_step(p, cache,
                                       {k: t(v) for k, v in inp.items()})
        close(got, want, MODEL_TOL)
        np.testing.assert_allclose(f32(got[:, 0]), f32(full[:, step]),
                                   **DECODE_TOL)
    jax.tree.map(lambda a, b: close(a, b, MODEL_TOL), cache,
                 carry(ref_cache))


def test_audio_decode_takes_codes():
    """A (B, 1, C) codes input: the codebooks' embeddings summed."""
    ref_model, ref_p, model, p = _pair(AUDIO, cache_dtype=jnp.float32)
    model = LMModel(REDUCED[AUDIO], device="cpu", cache_dtype=torch.float32)
    rng = np.random.RandomState(8)
    ref_cache = ref_model.init_cache(B, 8)
    cache = model.init_cache(B, 8)
    for _ in range(4):
        codes = rng.randint(0, REDUCED[AUDIO].vocab_size,
                            (B, 1, 4)).astype(np.int32)
        want, ref_cache = ref_model.decode_step(
            ref_p, ref_cache, {"codes": jnp.asarray(codes)})
        got, cache = model.decode_step(p, cache, {"codes": t(codes)})
        assert got.shape == (B, 1, 4, model.padded.vocab_size)
        close(got, want, MODEL_TOL)


SERVE_ARGS = ["--arch", AUDIO, "--reduced", "--requests", "10",
              "--wave-slots", "4", "--max-new", "5", "--n-pages", "6"]


def test_codebook_serving_wave_matches_reference(monkeypatch):
    """The serve loop feeds audio waves zero codes, as the reference's:
    the same statistics, and on the reference's weights the same cache."""
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
    assert want["admission_stalls"] > 0 and want["completed"] == 10

    calls = []
    orig = LMModel.decode_step

    def recording(self, params, cache, batch):
        calls.append(sorted(batch))
        return orig(self, params, cache, batch)

    monkeypatch.setattr(LMModel, "decode_step", recording)
    stats, batcher = port_serve.serve(
        port_serve.parse_args(SERVE_ARGS + ["--device", "cpu"]),
        params=carry(made[0].params))
    assert stats == want
    assert calls and all(c == ["codes"] for c in calls)
    jax.tree.map(lambda a, b: close(a, b, MODEL_TOL), batcher.cache,
                 carry(made[0].cache))


def test_serve_takes_the_callers_arch():
    """``serve(args, arch=...)`` serves the given config (a depth cut)
    in place of ``get_arch(args.arch)``."""
    cut = dataclasses.replace(REDUCED["phi3.5-moe"], n_layers=2)
    args = port_serve.parse_args(["--arch", "phi3.5-moe", "--requests", "3",
                                  "--wave-slots", "2", "--max-new", "2",
                                  "--device", "cpu"])
    stats, batcher = port_serve.serve(args, arch=cut)
    assert batcher.model.arch is cut
    assert batcher.cache["blocks"]["k"].shape[0] == 2
    assert stats["completed"] == 3 and stats["tokens_out"] == 6


@pytest.mark.parametrize("name", ["phi3.5-moe", VLM, AUDIO])
def test_from_reference_carries_the_trees(name):
    """Every leaf of the reference's parameter and cache trees lands in the
    port's layout: the same paths, shapes, dtypes and values."""
    ref_model = RefLM(REF_REDUCED[name], remat="none")
    ref_p = jax.tree.map(np.asarray, ref_init(ref_model.schema(), KEY,
                                              jnp.float32))
    model = LMModel(REDUCED[name], device="cpu")
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_leaves_with_path(ref_p)}
    got = from_reference(ref_p, CPU)
    schema = model.schema()

    def walk(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                yield from walk(v, path)
            else:
                yield path, v
    flat_got = dict(walk(got))
    assert flat_got.keys() == flat_ref.keys() == dict(walk(schema)).keys()
    assert param_count(schema) == sum(v.size for v in flat_ref.values())
    for path, v in flat_got.items():
        np.testing.assert_array_equal(v.numpy(), flat_ref[path])
        assert tuple(v.shape) == dict(walk(schema))[path].shape
    leaves = {"phi3.5-moe": "blocks/moe/w_gate", VLM: "blocks/attn/bq",
              AUDIO: "head_codes"}[name]
    assert leaves in flat_got
    ref_cache = jax.tree.map(np.asarray, ref_model.init_cache(B, 8))
    cache = from_reference(ref_cache, CPU)
    mine = model.init_cache(B, 8)
    jax.tree.map(lambda a, b: (a.shape == b.shape and a.dtype == b.dtype)
                 or pytest.fail(f"{a.shape} {a.dtype} {b.shape} {b.dtype}"),
                 cache, mine)
