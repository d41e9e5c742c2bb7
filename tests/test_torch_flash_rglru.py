"""The port's attention and linear-scan kernels' plain versions against the
JAX reference.

On the CPU ``flash_attention`` and ``linear_scan`` run their plain PyTorch
versions; these tests give them and the reference's Pallas bodies
(interpret mode) and oracles the same numpy inputs. The CUDA kernels run
only on a card: tests/test_torch_cuda.py holds them against the plain
versions there. Every tolerance is float32 round-off: 1e-5 absolute and
relative (both sides sum the same products in different orders).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_attention
from repro.kernels.rglru_scan import linear_scan as ref_scan
from repro.kernels.rglru_scan.ref import linear_scan_ref
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_chunked,
                                                     attention_naive)
from repro_torch.kernels.rglru_scan import linear_scan
from repro_torch.kernels.rglru_scan.ref import (linear_scan_doubling,
                                                linear_scan_sequential)

TOL = dict(atol=1e-5, rtol=1e-5)

ATTN_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, window, q_offset)
    (2, 24, 24, 2, 2, 16, None, 0),         # causal, no window, GQA 1
    (1, 24, 24, 4, 2, 16, 5, 0),            # window < S, GQA 2
    (1, 16, 40, 4, 1, 16, None, 24),        # q_offset > 0 (chunked prefill)
    (2, 20, 20, 8, 2, 64, 7, 0),            # GQA 4, D 64
    (1, 21, 21, 10, 1, 16, 8, 0),           # GQA 10 (recurrentgemma), S odd
    (1, 8, 8, 2, 1, 16, 4, 20),             # every row sees no key: 0
    (1, 12, 12, 2, 1, 16, 0, 0),            # window 0: no key visible
]


def _qkv(case, seed):
    B, Sq, Skv, Hq, Hkv, D, _, _ = case
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, Hq, D).astype(np.float32),
            rng.randn(B, Skv, Hkv, D).astype(np.float32),
            rng.randn(B, Skv, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("ref_mode", ["interpret", "ref"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_attention_matches_reference(case, ref_mode):
    window, q_offset = case[6], case[7]
    q, k, v = _qkv(case, sum(case[:6]))
    want = np.asarray(ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=q_offset, mode=ref_mode))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window,
                          q_offset=q_offset)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case in ATTN_CASES[:5]:
        # the naive softmax spreads a row that sees no key evenly over all
        # keys (as the reference's naive oracle does), so it is held to the
        # cases where every row sees a key
        naive = attention_naive(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window,
                                q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), naive.numpy(), **TOL)


def test_rows_without_a_visible_key_are_zero():
    case = ATTN_CASES[5]
    q, k, v = (torch.from_numpy(x) for x in _qkv(case, 3))
    got = flash_attention(q, k, v, window=4, q_offset=20)
    assert torch.equal(got, torch.zeros_like(got))


def test_chunked_blocks_do_not_change_the_result():
    q, k, v = (torch.from_numpy(x)
               for x in _qkv((2, 36, 36, 6, 3, 16, 9, 0), 11))
    whole = attention_chunked(q, k, v, window=9)
    tiled = attention_chunked(q, k, v, window=9, block_q=6, block_k=4)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), **TOL)


def test_attention_dispatch_follows_the_device():
    q, k, v = (torch.from_numpy(x) for x in _qkv(ATTN_CASES[0], 5))
    assert common.kernel_mode(None, q.device) == "ref"
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k, v, mode="cuda")
    # a gradient goes through the op (its backward is plain on every
    # device, as in the reference) and launches nothing
    before = common.LAUNCHES["flash_attention"]
    flash_attention(q.requires_grad_(), k, v).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert common.LAUNCHES["flash_attention"] == before


def _ab(seed, shape):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.01, 0.99, shape).astype(np.float32)   # gates: (0, 1)
    b = rng.randn(*shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(2, 37, 24), (2, 1, 8), (1, 100, 5)])
def test_plain_scan_matches_reference(shape):
    a, b = _ab(shape[1], shape)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == a.shape and got.dtype == torch.float32
    for want in (ref_scan(jnp.asarray(a), jnp.asarray(b), "interpret"),
                 linear_scan_ref(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    doubling = linear_scan_doubling(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), doubling.numpy(), **TOL)


def test_sequential_scan_is_the_recurrence():
    a, b = _ab(1, (2, 9, 3))
    h = linear_scan_sequential(torch.from_numpy(a), torch.from_numpy(b))
    want = np.zeros((2, 3), np.float32)
    for t in range(9):
        want = a[:, t] * want + b[:, t]
        np.testing.assert_array_equal(h[:, t].numpy(), want)


def test_scan_dispatch_follows_the_device():
    a, b = (torch.from_numpy(x) for x in _ab(2, (1, 5, 4)))
    with pytest.raises(ValueError, match="CUDA device"):
        linear_scan(a, b, mode="cuda")
    # a gradient goes through the op; on the CPU its reversed scan is the
    # plain version too
    before = common.LAUNCHES["rglru_scan"]
    linear_scan(a.requires_grad_(), b).sum().backward()
    assert a.grad is not None and a.grad.shape == a.shape
    assert common.LAUNCHES["rglru_scan"] == before
