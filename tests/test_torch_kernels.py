"""The port's kernels (repro_torch.kernels) against the JAX reference.

On the CPU a wrapper runs its plain PyTorch version; these tests give it
and the reference's Pallas body (interpret mode) and oracle the same numpy
inputs. The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py holds them against the plain versions there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.hash_aggregate import hash_aggregate_multi as ref_agg
from repro.kernels.join_probe import join_probe as ref_probe
from repro_torch.kernels import common
from repro_torch.kernels.hash_aggregate import hash_aggregate_multi
from repro_torch.kernels.hash_aggregate.ops import launch_plan, smem_bytes
from repro_torch.kernels.join_probe import join_probe
from repro_torch.kernels.join_probe.ref import join_probe_ref


def _agg_inputs(seed, P, T, C, n_bins):
    rng = np.random.RandomState(seed)
    ids = rng.randint(-3, n_bins + 3, (P, T)).astype(np.int32)  # out of range
    vals = (rng.randn(P, T, C) * 100).astype(np.float32)
    vals[:, -T // 8:] = 0.0                       # padding rows carry 0
    return ids, vals


@pytest.mark.parametrize("ref_mode", ["ref", "interpret"])
@pytest.mark.parametrize("P,T,C,n_bins", [(2, 512, 1, 128), (3, 1024, 3, 256),
                                          (1, 512, 6, 200)])
def test_hash_aggregate_multi_matches_reference(ref_mode, P, T, C, n_bins):
    ids, vals = _agg_inputs(P * 7 + C, P, T, C, n_bins)
    want = np.asarray(ref_agg(jnp.asarray(ids), jnp.asarray(vals),
                              n_bins=n_bins, block=256, mode=ref_mode))
    got = hash_aggregate_multi(torch.from_numpy(ids), torch.from_numpy(vals),
                               n_bins=n_bins)
    assert got.shape == (P, n_bins, C) and got.dtype == torch.float32
    # both are f32 sums of the same rows in different orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def test_hash_aggregate_single_column_and_empty_bins():
    ids, vals = _agg_inputs(5, 2, 512, 1, 128)
    got = hash_aggregate_multi(torch.from_numpy(ids), torch.from_numpy(vals),
                               n_bins=128)[..., 0]
    want = np.zeros((2, 128), np.float32)
    for p in range(2):
        ok = (ids[p] >= 0) & (ids[p] < 128)
        np.add.at(want[p], ids[p][ok], vals[p, ok, 0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def _probe_inputs(seed, P, Bk, Pk):
    rng = np.random.RandomState(seed)
    bk = np.stack([rng.permutation(3 * Bk)[:Bk] for _ in range(P)])
    bk = bk.astype(np.int32)
    bk[:, -Bk // 4:] = -1                          # build padding
    bv = rng.randint(0, 1 << 20, (P, Bk)).astype(np.float32)
    bv[bk < 0] = 0.0
    pk = rng.randint(0, 3 * Bk, (P, Pk)).astype(np.int32)   # many misses
    pk[:, ::5] = -1                                # probe padding
    return bk, bv, pk


@pytest.mark.parametrize("ref_mode", ["ref", "interpret"])
@pytest.mark.parametrize("P,Bk,Pk", [(2, 64, 256), (4, 128, 300),
                                     (1, 40, 1000)])
def test_join_probe_matches_reference(ref_mode, P, Bk, Pk):
    bk, bv, pk = _probe_inputs(P + Bk, P, Bk, Pk)
    wv, wf = ref_probe(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                       block_p=128, mode=ref_mode)
    gv, gf = join_probe(torch.from_numpy(bk), torch.from_numpy(bv),
                        torch.from_numpy(pk))
    # unique keys: each sum has at most one non-zero term, so it is exact
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))


@pytest.mark.parametrize("max_elems", [1, 1000, 1 << 26])
def test_join_probe_ref_chunking_is_exact(max_elems):
    bk, bv, pk = _probe_inputs(3, 3, 50, 333)
    args = (torch.from_numpy(bk), torch.from_numpy(bv), torch.from_numpy(pk))
    v0, f0 = join_probe_ref(*args, max_elems=1 << 30)
    v1, f1 = join_probe_ref(*args, max_elems=max_elems)
    assert torch.equal(v0, v1) and torch.equal(f0, f1)


def test_kernel_mode_follows_the_tensor_device(monkeypatch):
    monkeypatch.delenv(common.ENV_VAR, raising=False)
    assert common.kernel_mode(None, torch.device("cpu")) == "ref"
    assert common.kernel_mode(None, torch.device("cuda")) == "cuda"
    assert common.kernel_mode("ref", torch.device("cuda")) == "ref"
    assert common.kernel_mode(None) == "auto"
    monkeypatch.setenv(common.ENV_VAR, "ref")
    assert common.kernel_mode(None, torch.device("cuda")) == "ref"
    with pytest.raises(ValueError):
        common.kernel_mode("pallas")


def test_forced_cuda_mode_on_cpu_tensors_raises_instead_of_falling_back():
    ids, vals = _agg_inputs(1, 1, 512, 2, 128)
    before = dict(common.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        hash_aggregate_multi(torch.from_numpy(ids), torch.from_numpy(vals),
                             n_bins=128, mode="cuda")
    bk, bv, pk = _probe_inputs(1, 1, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        join_probe(torch.from_numpy(bk), torch.from_numpy(bv),
                   torch.from_numpy(pk), mode="cuda")
    assert common.LAUNCHES == before               # nothing counted


@pytest.mark.parametrize("P,T,C,n_bins", [(8, 750_080, 5, 128),
                                          (64, 187_648, 2, 23_552),
                                          (1, 100, 1, 128)])
def test_hash_aggregate_launch_plan_fits_shared_memory(P, T, C, n_bins):
    tile_bins, n_chunks, rows, private = launch_plan(P, T, C, n_bins,
                                                     n_sms=132)
    # the table(s) and the STAGES staged batches fit one block's shared
    # memory
    assert smem_bytes(tile_bins, C, private) <= 232_448
    assert n_chunks * rows >= T > (n_chunks - 1) * rows
    assert n_chunks >= 1 and 1 <= tile_bins <= n_bins
    if n_bins == 23_552:                           # q18: one tile, rows read once
        assert tile_bins == n_bins and not private
