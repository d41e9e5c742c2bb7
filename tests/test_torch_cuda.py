"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device each test skips (a CUDA kernel has
no CPU mode). This file imports neither jax nor the reference package, so
it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.hash_aggregate import hash_aggregate_multi
from repro_torch.kernels.join_probe import join_probe


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P,T,C,n_bins", [(4, 40_000, 3, 5000),
                                          (1, 9_999, 7, 20_000),
                                          (8, 4096, 1, 128)])
def test_cuda_hash_aggregate_matches_plain_and_is_deterministic(
        dev, P, T, C, n_bins):
    rng = np.random.RandomState(P * C)
    ids = rng.randint(-3, n_bins + 3, (P, T)).astype(np.int32)
    vals = (rng.randn(P, T, C) * 100).astype(np.float32)
    ids_t = torch.from_numpy(ids).to(dev)
    vals_t = torch.from_numpy(vals).to(dev)
    before = common.LAUNCHES["hash_aggregate_multi"]
    a = hash_aggregate_multi(ids_t, vals_t, n_bins=n_bins)
    b = hash_aggregate_multi(ids_t, vals_t, n_bins=n_bins)
    assert common.LAUNCHES["hash_aggregate_multi"] == before + 2
    want = hash_aggregate_multi(ids_t.cpu(), vals_t.cpu(), n_bins=n_bins)
    assert torch.equal(a, b)                      # no float atomics
    np.testing.assert_allclose(a.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,Bk,Pk", [(8, 5000, 7001), (2, 100, 513)])
def test_cuda_join_probe_matches_plain(dev, P, Bk, Pk):
    rng = np.random.RandomState(Bk)
    bk = np.stack([rng.permutation(3 * Bk)[:Bk] for _ in range(P)])
    bk = bk.astype(np.int32)
    bk[:, -Bk // 4:] = -1
    bv = rng.randint(0, 1 << 20, (P, Bk)).astype(np.float32)
    bv[bk < 0] = 0.0
    pk = rng.randint(-1, 3 * Bk, (P, Pk)).astype(np.int32)
    got = join_probe(*(torch.from_numpy(x).to(dev) for x in (bk, bv, pk)))
    want = join_probe(*(torch.from_numpy(x) for x in (bk, bv, pk)))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
