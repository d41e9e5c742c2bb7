"""The port's rwkv6-7b serving path against the JAX reference on the CPU.

Inputs come from numpy seeds; weights are drawn once by the reference's
``init_params`` and carried across with ``core.params.from_reference``.
The reference's Pallas WKV6 body cannot run in interpret mode on this jax
(``pl.store`` is missing), so the reference runs in ``ref`` mode
throughout and the port is held to ``wkv6_ref``. On the CPU the port's
``wkv6`` runs its plain version; the CUDA kernel is held to that version
on a card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances: 1e-5 for
the scan and one module (float32 round-off of the same products summed in
other orders), 1e-4 for logits after the whole reduced model (that
round-off carried through 4 layers and the head), 2e-3 for decode against
forward within the port (the reference's own bound for that,
tests/test_models_parity.py).
"""
import contextlib
import functools
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
from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.rwkv6_scan.ref import wkv6_step_ref as jax_wkv6_step
from repro.launch import serve as ref_serve
from repro.models import rwkv6 as ref_rwkv
from repro.models.lm import LMModel as RefLM
from repro_torch.configs.reduced import REDUCED
from repro_torch.core.params import from_reference
from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_step
from repro_torch.kernels.rwkv6_scan.ref import pairwise_sum, wkv6_ref
from repro_torch.launch import serve as port_serve
from repro_torch.models import rwkv6
from repro_torch.models.lm import LMModel

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
KEY = jax.random.PRNGKey(0)
NAME = "rwkv6-7b"
B, S = 2, 20
CPU = torch.device("cpu")


def carry(tree):
    """The reference's tree as the port's tensors on the CPU."""
    return from_reference(jax.tree.map(np.asarray, tree), CPU)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def scan_inputs(shape, seed, w_lo=0.6, w_hi=0.99):
    """r, k, v, w (B, S, H, N) and u (H, N), as the reference's own wkv6
    tests draw them."""
    Bn, Sn, H, N = shape
    rng = np.random.RandomState(seed)
    r, k, v = ((rng.randn(*shape) * 0.5).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, shape).astype(np.float32)
    u = (rng.randn(H, N) * 0.5).astype(np.float32)
    return r, k, v, w, u


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 16, 1, 8), (2, 37, 3, 16),
                                   (1, 64, 2, 32), (2, 5, 4, 64),
                                   (1, 1, 2, 16)])
def test_plain_wkv6_matches_reference(shape):
    r, k, v, w, u = scan_inputs(shape, sum(shape))
    want_y, want_s = jax_wkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    before = dict(common.LAUNCHES)
    y, s = wkv6(*(t(a) for a in (r, k, v, w, u)))
    assert common.LAUNCHES == before          # the plain version: no launch
    assert y.shape == shape and y.dtype == torch.float32
    assert s.shape == (shape[0], shape[2], shape[3], shape[3])
    close(y, want_y, SCAN_TOL)
    close(s, want_s, SCAN_TOL)


def test_plain_wkv6_from_a_state_matches_reference():
    shape = (2, 23, 3, 16)
    r, k, v, w, u = scan_inputs(shape, 5)
    s0 = np.random.RandomState(6).randn(2, 3, 16, 16).astype(np.float32)
    want_y, want_s = jax_wkv6_ref(*(jnp.asarray(a)
                                    for a in (r, k, v, w, u, s0)))
    y, s = wkv6_ref(*(t(a) for a in (r, k, v, w, u, s0)))
    close(y, want_y, SCAN_TOL)
    close(s, want_s, SCAN_TOL)


@pytest.mark.parametrize("N", [8, 16, 64])
def test_plain_wkv6_takes_the_kernels_order_bit_for_bit(N):
    """The CUDA kernel reproduces ``wkv6_ref`` bit for bit by taking its
    operations in its order: each product and sum rounded on its own, and
    the sum over the key dim a pairwise tree. A float32 numpy evaluation in
    that order must give the same bits."""
    r, k, v, w, u = scan_inputs((2, 9, 3, N), N)
    y, s = wkv6_ref(*(t(a) for a in (r, k, v, w, u)))
    state = np.zeros((2, 3, N, N), np.float32)
    for step in range(9):
        kv = k[:, step, :, :, None] * v[:, step, :, None, :]
        p = r[:, step, :, :, None] * (state + u[:, :, None] * kv)
        while p.shape[-2] > 1:
            p = p[..., 0::2, :] + p[..., 1::2, :]
        np.testing.assert_array_equal(y[:, step].numpy(), p[..., 0, :])
        state = w[:, step, :, :, None] * state + kv
    np.testing.assert_array_equal(s.numpy(), state)


def test_pairwise_sum_order():
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    # ((1e8 + 1) + (-1e8 + 1)) + 3: each pair rounds away its 1, where a
    # left-to-right sum keeps the second one and gives 4
    assert float(pairwise_sum(x[:, None])) == 3.0
    seq = torch.zeros(())
    for e in x:
        seq = seq + e
    assert float(seq) == 4.0
    m = torch.arange(42, dtype=torch.float32).reshape(2, 7, 3)
    torch.testing.assert_close(pairwise_sum(m), m.sum(-2))


def test_wkv6_step_matches_reference():
    r, k, v, w, u = scan_inputs((3, 1, 4, 16), 11)
    state = np.random.RandomState(12).randn(3, 4, 16, 16).astype(np.float32)
    args = [a[:, 0] for a in (r, k, v, w)] + [u, state]
    want_y, want_s = jax_wkv6_step(*(jnp.asarray(a) for a in args))
    y, s = wkv6_step(*(t(a) for a in args))
    close(y, want_y, SCAN_TOL)
    close(s, want_s, SCAN_TOL)


def test_wkv6_cuda_mode_on_a_cpu_tensor_raises():
    r, k, v, w, u = (t(a) for a in scan_inputs((1, 4, 1, 16), 0))
    before = common.LAUNCHES["wkv6"]
    with pytest.raises(ValueError, match="CUDA device"):
        wkv6(r, k, v, w, u, mode="cuda")
    assert common.LAUNCHES["wkv6"] == before


def test_wkv6_refuses_a_gradient():
    """The name is kept from when the op refused a gradient; the test now
    checks the opposite, that the gradient flows: the op's backward is
    autograd through ``wkv6_ref``, so the gradient is that one's bit for
    bit."""
    ins = [t(a).requires_grad_(True) for a in scan_inputs((1, 4, 1, 16), 0)]
    y, s = wkv6(*ins)
    got = torch.autograd.grad((y * 1.5).sum() + s.square().sum(), ins)
    y, s = wkv6_ref(*ins)
    want = torch.autograd.grad((y * 1.5).sum() + s.square().sum(), ins)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        wkv6(*ins)


# ---------------------------------------------------------------------------
# the time mix and the channel mix
# ---------------------------------------------------------------------------
def _block_params():
    arch = REF_REDUCED[NAME]
    p = ref_init(ref_rwkv.rwkv_schema(arch), KEY, jnp.float32)
    # a nonzero group-norm bias and scale, so both are exercised
    p = dict(p, ln_x_bias=p["mu_x"], ln_x_scale=1.0 + p["mu_r"])
    return arch, p, carry(p)


def test_group_norm_uses_the_population_variance():
    rng = np.random.RandomState(3)
    y = (rng.randn(2, 5, 64) * 3 + 1).astype(np.float32)
    scale, bias = rng.randn(64).astype(np.float32), \
        rng.randn(64).astype(np.float32)
    got = rwkv6._group_norm(t(y), t(scale), t(bias), 4)
    close(got, ref_rwkv._group_norm(jnp.asarray(y), jnp.asarray(scale),
                                    jnp.asarray(bias), 4), MODULE_TOL)
    yh = y.reshape(2, 5, 4, 16)
    want = ((yh - yh.mean(-1, keepdims=True))
            / np.sqrt(yh.var(-1, ddof=0, keepdims=True) + 64e-5))
    close(got, want.reshape(2, 5, 64) * scale + bias, MODULE_TOL)


def test_decay_clips_and_mixes_keep_their_order():
    arch, p, tp = _block_params()
    rng = np.random.RandomState(4)
    x = rng.randn(B, 7, arch.d_model).astype(np.float32)
    sx = rng.randn(B, 7, arch.d_model).astype(np.float32)
    want = ref_rwkv._mixes(p, jnp.asarray(x), jnp.asarray(sx))
    got = rwkv6._mixes(tp, t(x), t(sx))
    assert tuple(got) == ("w", "k", "v", "r", "g")
    for kind in got:
        close(got[kind], want[kind], MODULE_TOL)
    # a LoRA output large enough that w0 + dd leaves [-8, 8] on both sides
    p = dict(p, decay_w2=p["decay_w2"] * 200)
    tp = dict(tp, decay_w2=tp["decay_w2"] * 200)
    wd = rwkv6._decay(tp, t(x))
    close(wd, ref_rwkv._decay(p, jnp.asarray(x)), MODULE_TOL)
    dd = torch.tanh(t(x) @ tp["decay_w1"]) @ tp["decay_w2"]
    raw = tp["decay_w0"] + dd
    assert bool((raw > 8).any()) and bool((raw < -8).any())
    assert float(wd.min()) == pytest.approx(np.exp(-np.exp(8.0)), abs=0)
    assert float(wd.max()) == pytest.approx(np.exp(-np.exp(-8.0)),
                                            rel=1e-6)


def test_time_and_channel_mix_forward_and_decode_match_reference():
    arch, p, tp = _block_params()
    port_arch = REDUCED[NAME]
    x = np.random.RandomState(1).randn(B, 11, arch.d_model)
    x = x.astype(np.float32)
    close(rwkv6.time_mix_forward(tp, t(x), port_arch),
          ref_rwkv.time_mix_forward(p, jnp.asarray(x), arch, "ref"),
          MODULE_TOL)
    close(rwkv6.channel_mix_forward(tp, t(x)),
          ref_rwkv.channel_mix_forward(p, jnp.asarray(x)), MODULE_TOL)

    ref_cache = ref_rwkv.rwkv_init_cache(arch, B)       # bf16 shifts
    cache = carry(ref_cache)
    assert cache["shift_tm"].dtype == torch.bfloat16
    assert cache["wkv"].dtype == torch.float32
    for step in range(5):
        xs = x[:, step:step + 1]
        want, ref_cache = ref_rwkv.time_mix_decode(p, jnp.asarray(xs),
                                                   ref_cache, arch)
        got, cache = rwkv6.time_mix_decode(tp, t(xs), cache, port_arch)
        close(got, want, MODULE_TOL)
        want, ref_cache = ref_rwkv.channel_mix_decode(p, jnp.asarray(xs),
                                                      ref_cache)
        got, cache = rwkv6.channel_mix_decode(tp, t(xs), cache)
        close(got, want, MODULE_TOL)
        close(cache["wkv"], ref_cache["wkv"], MODULE_TOL)
        # the shift states stay in the cache's dtype
        for name in ("shift_tm", "shift_cm"):
            assert cache[name].dtype == torch.bfloat16
            assert torch.equal(cache[name], t(xs[:, 0]).to(torch.bfloat16))
        assert cache["wkv"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def _pair(cache_dtype):
    ref_model = RefLM(REF_REDUCED[NAME], remat="none", kernel_mode="ref",
                      cache_dtype=cache_dtype)
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    model = LMModel(REDUCED[NAME], device="cpu",
                    cache_dtype={jnp.bfloat16: torch.bfloat16,
                                 jnp.float32: torch.float32}[cache_dtype])
    return ref_model, ref_p, model, carry(ref_p)


def _tokens(arch, seed, steps=S):
    rng = np.random.RandomState(seed)
    return rng.randint(1, arch.vocab_size, (B, steps)).astype(np.int32)


def close_cache(mine, ref):
    """A cache entry against the reference's; a bfloat16 entry may sit one
    bfloat16 step (2^-7 of the value) away, where two float32 values 1e-7
    apart round to neighbouring bfloat16 values."""
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    if mine.dtype != torch.bfloat16:
        close(mine, ref, MODEL_TOL)
        return
    a, b = mine.float(), ref.float()
    step = b.abs() * 2.0 ** -7
    assert bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs() + step).all())


def test_rwkv_params_have_the_reference_layout():
    ref_model, ref_p, model, _ = _pair(jnp.bfloat16)
    assert model.plan == {"kind": "rwkv", "n": 4}
    ref_leaves = {"/".join(str(getattr(k, "key", k)) for k in path): v.shape
                  for path, v in jax.tree_util.tree_leaves_with_path(ref_p)}
    mine = model.init_params(seed=0)

    def walk(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                yield from walk(v, path)
            else:
                yield path, tuple(v.shape)
    assert dict(walk(mine)) == ref_leaves
    assert "blocks/tm/cm_wk" in ref_leaves and "blocks/mlp" not in \
        {p.rsplit("/", 1)[0] for p in ref_leaves}


def test_rwkv_forward_and_prefill_match_reference():
    ref_model, ref_p, model, p = _pair(jnp.bfloat16)
    toks = _tokens(model.arch, 3)
    want, _, _ = ref_model.forward(ref_p, {"tokens": jnp.asarray(toks)})
    got, _, _ = model.forward(p, {"tokens": t(toks)})
    close(got, want, MODEL_TOL)
    last, _ = model.prefill(p, {"tokens": t(toks)})
    assert last.shape == (B, 1, model.padded.vocab_size)
    close(last, got[:, -1:], MODULE_TOL)


@pytest.mark.parametrize("cache_dtype", [jnp.bfloat16, jnp.float32])
def test_rwkv_decode_matches_reference(cache_dtype):
    """S decode steps against the reference's. With the serving launcher's
    default bf16 cache each step starts from the reference's cache: a
    shift entry one bf16 step away (a float32 value within ~4e-7 of a
    rounding midpoint, on either side in the two packages) changes the
    next token's mixes by up to 2^-8 of that entry, so free-running bf16
    decodes part by ~1e-3 in the logits after it. The float32 cache runs
    free over all S steps."""
    ref_model, ref_p, model, p = _pair(cache_dtype)
    toks = _tokens(model.arch, 3)
    ref_cache = ref_model.init_cache(B, S + 4)
    cache = model.init_cache(B, S + 4)
    assert set(cache["blocks"]) == {"wkv", "shift_tm", "shift_cm"}
    ref_step = jax.jit(ref_model.decode_step)
    for step in range(S):
        if cache_dtype == jnp.bfloat16:
            cache = carry(ref_cache)
        col = toks[:, step:step + 1]
        want, ref_cache = ref_step(ref_p, ref_cache,
                                   {"tokens": jnp.asarray(col)})
        got, cache = model.decode_step(p, cache, {"tokens": t(col)})
        close(got, want, MODEL_TOL)
        jax.tree.map(close_cache, cache, carry(ref_cache))
    assert cache["blocks"]["shift_tm"].dtype == \
        {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[cache_dtype]
    assert cache["len"].tolist() == [S] * B


@pytest.mark.parametrize("steps", [12, 25])
def test_rwkv_decode_matches_forward_in_the_port(steps):
    model = LMModel(REDUCED[NAME], device="cpu", cache_dtype=torch.float32)
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


SERVE_ARGS = ["--arch", NAME, "--reduced", "--requests", "12",
              "--wave-slots", "4", "--max-new", "6", "--n-pages", "6"]


def test_rwkv_serve_launcher_matches_reference(monkeypatch):
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

    # on the reference's weights, the same waves leave the same cache; in
    # float32 on both sides, so that no shift entry rounds across a bf16
    # boundary in one package only (see test_rwkv_decode_matches_reference)
    monkeypatch.setattr(ref_serve, "LMModel",
                        functools.partial(RefLM, cache_dtype=jnp.float32))
    monkeypatch.setattr(port_serve, "LMModel",
                        functools.partial(LMModel, cache_dtype=torch.float32))
    with contextlib.redirect_stdout(io.StringIO()):
        ref_serve.main()
    stats, batcher = port_serve.serve(
        port_serve.parse_args(SERVE_ARGS + ["--device", "cpu"]),
        params=carry(made[1].params))
    assert stats == want
    assert batcher.cache["blocks"]["shift_tm"].dtype == torch.float32
    jax.tree.map(close_cache, batcher.cache, carry(made[1].cache))
