"""Gradients through the port's three LM kernel wrappers, on the CPU.

Each wrapper is a ``torch.autograd.Function`` whose backward is the
reference's: ``flash_attention`` recomputes (out, lse) with the plain
chunked attention and runs the blockwise manual backward; ``linear_scan``
runs the same scan reversed; ``wkv6`` takes the vjp of ``wkv6_ref``. The
same numpy inputs and cotangents go through ``jax.vjp`` of the
reference's op and through the port. Tolerance: 1e-5 relative to the
largest |grad| (float32 round-off of the same products summed in other
orders); the flash helpers, the same function of the same blocks, 1e-5
absolute and relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_attention
from repro.kernels.flash_attention import ref as ref_fa
from repro.kernels.rglru_scan import linear_scan as ref_scan
from repro.kernels.rwkv6_scan import wkv6 as ref_wkv6
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_chunked, attention_chunked_bwd, attention_chunked_with_lse,
    attention_naive)
from repro_torch.kernels.rglru_scan import linear_scan
from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential
from repro_torch.kernels.rwkv6_scan import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

REL = 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)

ATTN_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset)
    (2, 24, 24, 2, 2, 16, True, None, 0),       # causal, MHA
    (1, 40, 40, 6, 2, 16, True, 7, 0),          # GQA 3, window
    (1, 16, 40, 4, 1, 16, True, None, 24),      # q_offset (a chunk)
    (2, 20, 20, 4, 2, 8, False, None, 0),       # not causal
    (1, 21, 21, 10, 1, 16, True, 8, 0),         # recurrentgemma's GQA 10
    (1, 8, 8, 2, 1, 16, True, 4, 20),           # rows that see no key
]


def held(got, want, rel=REL):
    """|got - want| <= rel * max|want| (got exactly 0 where want is)."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, (err, top)


def _attn_inputs(case, seed):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, Hq, D).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    g = rng.randn(B, Sq, Hq, D).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_lse_and_bwd_helpers_match_reference(case):
    """The ported ``attention_chunked_with_lse`` / ``_bwd`` against the
    reference's, with blocks small enough that every loop runs."""
    q, k, v, g = _attn_inputs(case, 1)
    causal, window, off = case[6:]
    kw = dict(causal=causal, window=window, q_offset=off, block_q=8,
              block_k=16)
    want_o, want_l = ref_fa.attention_chunked_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), **kw)
    o, lse = attention_chunked_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    finite = np.asarray(want_l) > -1e29        # rows that see some key
    np.testing.assert_allclose(lse.numpy()[finite],
                               np.asarray(want_l)[finite], **TOL)
    assert (lse.numpy()[~finite] < -1e29).all()
    # the plain forward is the same function: its out is with_lse's
    assert torch.equal(o, attention_chunked(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw))
    want = ref_fa.attention_chunked_bwd(
        *(jnp.asarray(x) for x in (q, k, v)), want_o, want_l,
        jnp.asarray(g), **kw)
    got = attention_chunked_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)), o, lse,
        torch.from_numpy(g), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_grads_match_reference_vjp(case):
    q, k, v, g = _attn_inputs(case, 2)
    causal, window, off = case[6:]
    kw = dict(causal=causal, window=window, q_offset=off)
    _, vjp = jax.vjp(lambda *x: ref_attention(*x, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = common.LAUNCHES["flash_attention"]
    got = torch.autograd.grad(flash_attention(*ins, **kw), ins,
                              torch.from_numpy(g))
    assert common.LAUNCHES["flash_attention"] == before
    naive = torch.autograd.grad(attention_naive(*ins, **kw), ins,
                                torch.from_numpy(g))
    for a, b, c in zip(got, want, naive):
        if float(np.abs(np.asarray(b)).max()) == 0.0:
            # no row sees a key: the kernel's and the chunked output is 0
            # there, the naive softmax's a uniform mix
            assert not a.any()
            continue
        held(a, b)
        held(a, c.numpy())


def _scan_inputs(shape, seed, lo=0.01, hi=0.99):
    rng = np.random.RandomState(seed)
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return a, b, g


@pytest.mark.parametrize("shape,lo,hi", [((2, 37, 24), 0.01, 0.99),
                                         ((1, 1, 8), 0.01, 0.99),
                                         ((2, 300, 16), 0.99, 0.9999)])
def test_linear_scan_grads_match_reference_vjp(shape, lo, hi):
    a, b, g = _scan_inputs(shape, shape[1], lo, hi)
    want = jax.jit(lambda x, y, c: jax.vjp(ref_scan, x, y)[1](c))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(g))
    ins = [torch.from_numpy(x).requires_grad_() for x in (a, b)]
    got = torch.autograd.grad(linear_scan(*ins), ins, torch.from_numpy(g))
    plain = torch.autograd.grad(linear_scan_sequential(*ins), ins,
                                torch.from_numpy(g))
    for x, y, z in zip(got, want, plain):
        assert x.dtype == torch.float32
        held(x, y)
        held(x, z.numpy())


def test_linear_scan_grads_keep_the_inputs_dtypes():
    a, b, g = _scan_inputs((1, 9, 4), 3)
    ins = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
           for x in (a, b)]
    da, db = torch.autograd.grad(linear_scan(*ins), ins, torch.from_numpy(g))
    assert da.dtype == db.dtype == torch.bfloat16


def _wkv_inputs(shape, seed):
    B, S, H, N = shape
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(*shape).astype(np.float32) * 0.5 for _ in range(3))
    w = rng.uniform(0.6, 0.99, shape).astype(np.float32)
    u = (rng.randn(H, N) * 0.5).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)
    gs = rng.randn(B, H, N, N).astype(np.float32)
    return (r, k, v, w, u), gy, gs


@pytest.mark.parametrize("shape", [(2, 11, 3, 16), (1, 1, 2, 8)])
def test_wkv6_grads_match_reference_vjp(shape):
    ins_np, gy, gs = _wkv_inputs(shape, shape[1])
    _, vjp = jax.vjp(lambda *x: ref_wkv6(*x, mode="ref"),
                     *(jnp.asarray(x) for x in ins_np))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    ins = [torch.from_numpy(x).requires_grad_() for x in ins_np]
    cot = (torch.from_numpy(gy), torch.from_numpy(gs))
    got = torch.autograd.grad(wkv6(*ins), ins, cot)
    plain = torch.autograd.grad(wkv6_ref(*ins), ins, cot)
    for x, y, z in zip(got, want, plain):
        held(x, y)
        assert torch.equal(x, z)      # the backward is wkv6_ref's vjp


def test_wkv6_grad_of_y_alone_matches_reference():
    """Only y feeds the loss: the final state's cotangent is zero."""
    ins_np, gy, _ = _wkv_inputs((1, 7, 2, 16), 5)
    _, vjp = jax.vjp(lambda *x: ref_wkv6(*x, mode="ref")[0],
                     *(jnp.asarray(x) for x in ins_np))
    want = vjp(jnp.asarray(gy))
    ins = [torch.from_numpy(x).requires_grad_() for x in ins_np]
    got = torch.autograd.grad(wkv6(*ins)[0], ins, torch.from_numpy(gy))
    for x, y in zip(got, want):
        held(x, y)
