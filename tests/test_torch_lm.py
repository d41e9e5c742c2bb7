"""The port's LM serving path against the JAX reference on the CPU.

Weights are drawn once by the reference's ``init_params`` and carried
across with ``repro_torch.core.params.from_reference``; tokens come from
numpy seeds. The reference runs its Pallas kernels in interpret mode where
it reaches them (``LMModel(kernel_mode="interpret")``). Tolerances: 1e-5
for one module (float32 round-off of the same products summed in other
orders), 1e-4 for logits after a whole reduced model (that round-off
carried through 4 layers and the head), 2e-3 for decode against forward
within the port (the reference's own bound for that, tests/
test_models_parity.py).
"""
import contextlib
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
from repro.memory.paged_kv import PagedKVManager as RefPagedKV
from repro.memory.paged_kv import gather_sequence as ref_gather
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import rglru as ref_rglru
from repro.models.lm import LMModel as RefLM
from repro_torch.configs.reduced import REDUCED
from repro_torch.core.config import PaddedDims
from repro_torch.core.params import from_reference, init_params, param_count
from repro_torch.launch import serve as port_serve
from repro_torch.memory.paged_kv import PagedKVManager, gather_sequence
from repro_torch.models import attention, layers, rglru
from repro_torch.models.lm import LMModel

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
KEY = jax.random.PRNGKey(0)
B, S = 2, 20
CPU = torch.device("cpu")


def carry(tree):
    """The reference's tree as the port's tensors on the CPU."""
    return from_reference(jax.tree.map(np.asarray, tree), CPU)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm_rope_and_gelu_swiglu_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, 16).astype(np.float32) * 3
    w = rng.randn(16).astype(np.float32)
    close(layers.rms_norm(t(x), t(w), 1e-6),
          ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6),
          MODULE_TOL)
    pos = np.arange(5, 12)
    close(layers.apply_rope(t(x), t(pos), 10_000.0),
          ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
          MODULE_TOL)
    h = rng.randn(2, 5, 24).astype(np.float32)
    wg, wu = (rng.randn(24, 40).astype(np.float32) * 0.3 for _ in range(2))
    wd = rng.randn(40, 24).astype(np.float32) * 0.2
    for act in ("gelu", "silu"):
        close(layers.swiglu(t(h), t(wg), t(wu), t(wd), act),
              ref_layers.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd)),
                                act), MODULE_TOL)
    # the reference's gelu is the tanh form, not the erf one
    z = torch.linspace(-4, 4, 101)
    assert torch.equal(layers.activation("gelu")(z),
                       torch.nn.functional.gelu(z, approximate="tanh"))
    assert not torch.allclose(layers.activation("gelu")(z),
                              torch.nn.functional.gelu(z), atol=1e-5)


# ---------------------------------------------------------------------------
# RG-LRU and GQA blocks
# ---------------------------------------------------------------------------
def test_rglru_forward_and_decode_match_reference():
    arch = REF_REDUCED["recurrentgemma-2b"]
    p = ref_init(ref_rglru.rglru_schema(arch), KEY, jnp.float32)
    # nonzero biases, so the gates' offsets are exercised too
    p = dict(p, b_a=p["w_a"] * 3, b_i=-p["w_i"] * 2, conv_b=p["w_a"])
    x = np.random.RandomState(1).randn(B, 11, arch.d_model).astype(np.float32)
    tp = carry(p)
    close(rglru.rglru_forward(tp, t(x), REDUCED["recurrentgemma-2b"]),
          ref_rglru.rglru_forward(p, jnp.asarray(x), arch, "interpret"),
          MODULE_TOL)
    ref_cache = ref_rglru.rglru_init_cache(arch, B, jnp.bfloat16)
    cache = carry(ref_cache)
    assert cache["conv"].dtype == torch.bfloat16
    for step in range(4):
        xs = x[:, step:step + 1]
        want, ref_cache = ref_rglru.rglru_decode(p, jnp.asarray(xs),
                                                 ref_cache, arch)
        got, cache = rglru.rglru_decode(tp, t(xs), cache,
                                        REDUCED["recurrentgemma-2b"])
        close(got, want, MODULE_TOL)
        close(cache["h"], ref_cache["h"], MODULE_TOL)
        close(cache["conv"], ref_cache["conv"], MODULE_TOL)
        # the conv state comes back in the activation's dtype
        assert cache["conv"].dtype == torch.float32
        assert ref_cache["conv"].dtype == jnp.float32


@pytest.mark.parametrize("name,window,ring", [
    ("recurrentgemma-2b", 8, True), ("qwen2-0.5b", None, False)])
def test_gqa_forward_and_decode_match_reference(name, window, ring):
    arch = REF_REDUCED[name]
    padded = PaddedDims.for_tp(REDUCED[name], 1)
    p = ref_init(ref_attn.gqa_schema(arch, padded), KEY, jnp.float32)
    if arch.qkv_bias:
        p = dict(p, bq=p["wq"][0] * 2, bk=p["wk"][0], bv=-p["wv"][0])
    steps = 13                                   # past the window of 8
    x = np.random.RandomState(2).randn(B, steps, arch.d_model)
    x = x.astype(np.float32)
    tp = carry(p)
    close(attention.gqa_forward(tp, t(x), REDUCED[name],
                                positions=torch.arange(steps),
                                window=window),
          ref_attn.gqa_forward(p, jnp.asarray(x), arch,
                               positions=jnp.arange(steps), window=window,
                               kernel_mode="interpret"), MODULE_TOL)
    buf = window if ring else steps + 3
    ref_cache = ref_attn.gqa_init_cache(arch, padded, B, buf, jnp.float32)
    cache = carry(ref_cache)
    for step in range(steps):
        xs = x[:, step:step + 1]
        length = np.full((B,), step, np.int32)
        want, ref_cache = ref_attn.gqa_decode(
            p, jnp.asarray(xs), ref_cache, jnp.asarray(length), arch,
            ring=ring)
        got, cache = attention.gqa_decode(tp, t(xs), cache, t(length),
                                          REDUCED[name], ring=ring)
        close(got, want, MODULE_TOL)
        close(cache["k"], ref_cache["k"], MODULE_TOL)
        close(cache["v"], ref_cache["v"], MODULE_TOL)


def test_gqa_decode_writes_one_shared_slot():
    """Every lane writes at lane 0's slot (cache_len[0] % buf), as the
    reference's dynamic_update_slice does."""
    arch = REDUCED["recurrentgemma-2b"]
    padded = PaddedDims.for_tp(arch, 1)
    gen = torch.Generator().manual_seed(0)
    p = init_params(attention.gqa_schema(arch, padded), gen)
    cache = attention.gqa_init_cache(arch, padded, 2, 8, torch.float32)
    x = torch.randn(2, 1, arch.d_model, generator=gen)
    _, cache = attention.gqa_decode(p, x, cache, torch.tensor([11, 4]),
                                    arch, ring=True)
    written = cache["k"].abs().sum(dim=(2, 3)) > 0
    assert written[:, 11 % 8].all() and int(written.sum()) == 2


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def test_params_have_the_reference_layout_counts_and_scales():
    arch = REDUCED["recurrentgemma-2b"]
    model = LMModel(arch, device="cpu")
    ref_model = RefLM(REF_REDUCED["recurrentgemma-2b"], remat="none")
    ref_p = jax.tree.map(np.asarray, ref_init(ref_model.schema(), KEY,
                                              jnp.float32))
    mine = model.init_params(seed=0)
    assert param_count(model.schema()) == sum(
        x.size for x in jax.tree.leaves(ref_p))
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_leaves_with_path(ref_p)}

    def walk(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                yield from walk(v, path)
            else:
                yield path, v
    seen = 0
    for path, v in walk(mine):
        ref = flat_ref[path]
        assert tuple(v.shape) == ref.shape and v.dtype == torch.float32
        seen += 1
        if ref.std() == 0:                      # zeros / ones
            np.testing.assert_array_equal(v.numpy(), ref)
        elif ref.size >= 1024:                  # same scale, other bits
            assert abs(float(v.std()) / float(ref.std()) - 1) < 0.1, path
    assert seen == len(flat_ref)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMModel(REDUCED["recurrentgemma-2b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.serve(port_serve.parse_args(
            ["--arch", "recurrentgemma-2b", "--reduced"]))


def test_from_reference_defaults_to_the_card():
    """Carrying weights across lands them on the card unless the caller
    asks for the CPU; without a card the default raises."""
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "blocks": {"n": np.zeros(4, np.int32)}}
    if torch.cuda.is_available():
        assert from_reference(tree)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            from_reference(tree)
    got = from_reference(tree, "cpu")
    assert got["w"].device.type == "cpu"
    assert torch.equal(got["w"], torch.from_numpy(tree["w"]))
    assert got["blocks"]["n"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def _pair(name, cache_dtype):
    ref_model = RefLM(REF_REDUCED[name], remat="none",
                      kernel_mode="interpret", cache_dtype=cache_dtype)
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    model = LMModel(REDUCED[name], device="cpu",
                    cache_dtype={jnp.bfloat16: torch.bfloat16,
                                 jnp.float32: torch.float32}[cache_dtype])
    return ref_model, ref_p, model, carry(ref_p)


def _tokens(arch, seed, steps=S):
    rng = np.random.RandomState(seed)
    return rng.randint(1, arch.vocab_size, (B, steps)).astype(np.int32)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "qwen2-0.5b"])
def test_forward_prefill_and_decode_match_reference(name):
    ref_model, ref_p, model, p = _pair(name, jnp.bfloat16)
    toks = _tokens(model.arch, 3)
    want, _, _ = ref_model.forward(ref_p, {"tokens": jnp.asarray(toks)})
    got, _, _ = model.forward(p, {"tokens": t(toks)})
    close(got, want, MODEL_TOL)
    last, _ = model.prefill(p, {"tokens": t(toks)})
    assert last.shape == (B, 1, model.padded.vocab_size)
    close(last, got[:, -1:], MODULE_TOL)

    # decode with the serving launcher's default bf16 cache
    ref_cache = ref_model.init_cache(B, S + 4)
    cache = model.init_cache(B, S + 4)
    ref_step = jax.jit(ref_model.decode_step)
    for step in range(S):
        col = toks[:, step:step + 1]
        want, ref_cache = ref_step(ref_p, ref_cache,
                                   {"tokens": jnp.asarray(col)})
        got, cache = model.decode_step(p, cache, {"tokens": t(col)})
        close(got, want, MODEL_TOL)
    jax.tree.map(close_cache, cache, carry(ref_cache))


def close_cache(mine, ref):
    """A cache entry against the reference's. A bfloat16 entry is a float32
    value rounded to 8 bits of mantissa: two float32 values 1e-7 apart on
    either side of a rounding boundary are stored one bfloat16 step (at
    most 2^-7 of the value) apart, so a bfloat16 entry may be one step
    off."""
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    if mine.dtype != torch.bfloat16:
        close(mine, ref, MODEL_TOL)
        return
    a, b = mine.float(), ref.float()
    step = b.abs() * 2.0 ** -7
    assert bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs() + step).all())


@pytest.mark.parametrize("name,steps", [
    ("recurrentgemma-2b", 12), ("qwen2-0.5b", 12),
    ("recurrentgemma-2b", 2 * 8 + 3)])          # past the window of 8
def test_decode_matches_forward_in_the_port(name, steps):
    model = LMModel(REDUCED[name], device="cpu", cache_dtype=torch.float32)
    p = model.init_params(seed=1)
    toks = t(_tokens(model.arch, 7, steps))
    full, _, _ = model.forward(p, {"tokens": toks})
    cache = model.init_cache(B, steps + 1)
    for step in range(steps):
        logits, cache = model.decode_step(p, cache,
                                          {"tokens": toks[:, step:step + 1]})
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, step].numpy(), atol=2e-3,
                                   rtol=2e-3)
    assert cache["len"].tolist() == [steps] * B


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_paged_kv_pages_and_gather_match_reference():
    mgrs = [PagedKVManager(n_pages=12, page_tokens=8, page_bytes=4096),
            RefPagedKV(n_pages=12, page_tokens=8, page_bytes=4096)]
    steps = [(0, 13), (1, 30), (0, 4), (2, 60), (1, 9), (3, 5)]
    for mgr in mgrs:
        for seq in range(4):
            mgr.add_sequence(seq)
    done = []
    for seq, n in steps:
        got = {mgr.append_tokens(seq, n, stream=seq) for mgr in mgrs}
        assert len(got) == 1
        done.append(got.pop())
    assert not all(done)                  # the 12 pages run out on the way
    for seq in range(4):
        np.testing.assert_array_equal(mgrs[0].page_table(seq, 6),
                                      mgrs[1].page_table(seq, 6))
    assert mgrs[0].fragmentation_ratio() == mgrs[1].fragmentation_ratio()
    pool = np.random.RandomState(4).randn(12, 8, 2, 3).astype(np.float32)
    table = mgrs[0].page_table(1, 6)
    length = mgrs[0].sequences[1].length
    np.testing.assert_array_equal(
        gather_sequence(t(pool), t(table), torch.tensor(length)).numpy(),
        np.asarray(ref_gather(jnp.asarray(pool), jnp.asarray(table),
                              jnp.asarray(length))))


SERVE_ARGS = ["--arch", "recurrentgemma-2b", "--reduced", "--requests", "12",
              "--wave-slots", "4", "--max-new", "6", "--n-pages", "6"]


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
    assert want["admission_stalls"] > 0          # the pages run short

    # the port's launcher, on its own seeded weights: the same statistics
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = port_serve.main(SERVE_ARGS + ["--device", "cpu"])
    assert json.loads(out.getvalue()) == got == want

    # on the reference's weights, the same waves leave the same cache
    stats, batcher = port_serve.serve(
        port_serve.parse_args(SERVE_ARGS + ["--device", "cpu"]),
        params=carry(made[0].params))
    assert stats == want
    jax.tree.map(close_cache, batcher.cache, carry(made[0].cache))
