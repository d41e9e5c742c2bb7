"""The three dense configs that no other parity test runs, against the JAX
reference on the CPU: qwen3-1.7b (qk-norm, tied embeddings), granite-3-8b
(tied embeddings) and yi-34b, reduced.

Weights are drawn by the reference's ``init_params`` and carried across
(``core.params.from_reference``); tokens come from numpy seeds. Each
config's forward logits, 20 decode steps over the serving launcher's
bf16 cache and ``loss_fn`` are held to the reference's with
tests/test_torch_lm.py's tolerances: 1e-4 for logits after a whole
reduced model, a bf16 cache entry at most one bf16 step off, and the
losses within 1e-5 relative (tests/test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core.params import init_params as ref_init
from repro.models.lm import LMModel as RefLM
from repro_torch.configs.reduced import REDUCED
from repro_torch.core.params import from_reference
from repro_torch.models.lm import LMModel

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
KEY = jax.random.PRNGKey(0)
B, S = 2, 20
CPU = torch.device("cpu")
NAMES = ["qwen3-1.7b", "granite-3-8b", "yi-34b"]


def carry(tree):
    return from_reference(jax.tree.map(np.asarray, tree), CPU)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def close_cache(mine, ref):
    """A cache entry against the reference's (carried across); a bfloat16
    entry may be one bfloat16 step (2^-7 of its value) off, as
    tests/test_torch_lm.py allows."""
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    a, b = mine.float(), ref.float()
    if mine.dtype != torch.bfloat16:
        close(a, b.numpy(), MODEL_TOL)
        return
    step = b.abs() * 2.0 ** -7
    assert bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs() + step).all())


def _tokens(arch, seed, steps=S):
    rng = np.random.RandomState(seed)
    return rng.randint(1, arch.vocab_size, (B, steps)).astype(np.int32)


def test_the_three_configs_keep_their_features_when_reduced():
    assert REDUCED["qwen3-1.7b"].qk_norm
    assert REDUCED["qwen3-1.7b"].tie_embeddings
    assert REDUCED["granite-3-8b"].tie_embeddings
    assert not REDUCED["yi-34b"].tie_embeddings
    for name in NAMES:
        assert REDUCED[name].family == "dense"


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_bf16_decode_match_reference(name):
    ref_model = RefLM(REF_REDUCED[name], remat="none",
                      kernel_mode="interpret", cache_dtype=jnp.bfloat16)
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    model = LMModel(REDUCED[name], device="cpu", cache_dtype=torch.bfloat16)
    p = carry(ref_p)
    toks = _tokens(model.arch, 3)
    want, _, _ = ref_model.forward(ref_p, {"tokens": jnp.asarray(toks)})
    got, _, _ = model.forward(p, {"tokens": t(toks)})
    close(got, want, MODEL_TOL)

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


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_reference(name):
    ref_model = RefLM(REF_REDUCED[name], remat="block")
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    ids = _tokens(REDUCED[name], 5, S + 1)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    want, want_m = jax.jit(lambda p, b: ref_model.loss_fn(
        p, b, z_loss=1e-4))(ref_p, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    model = LMModel(REDUCED[name], device="cpu")
    loss, m = model.loss_fn(carry(ref_p), {k: t(v) for k, v in batch.items()},
                            z_loss=1e-4)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for k in ("ce", "aux", "z"):
        np.testing.assert_allclose(float(m[k]), float(want_m[k]), rtol=1e-5,
                                   atol=1e-7)
