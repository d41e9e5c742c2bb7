"""The port's radix-partition ops (repro_torch.kernels.radix_partition)
against the JAX reference on the same numpy inputs.

On the CPU ``block_histograms`` runs its plain PyTorch version; the
reference runs its Pallas body in interpret mode and its jnp oracle. The
cases are those of the reference's named gate (negative keys with the -1
sentinel, padded bin counts at every misalignment, N = 0, unaligned
partitioning). The CUDA kernel is held against the plain version on a card
by tests/test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.radix_partition import ops as R
from repro_torch.kernels import common
from repro_torch.kernels.radix_partition import ops as T
from repro_torch.kernels.radix_partition.ref import block_histograms_ref


def _keys(seed, n, lo=-(1 << 24), hi=1 << 24):
    rng = np.random.RandomState(seed)
    keys = rng.randint(lo, hi, n).astype(np.int32)
    keys[::7] = -1                    # the routing layer's padding key
    return keys


@pytest.mark.parametrize("ref_mode", ["ref", "interpret"])
@pytest.mark.parametrize("n_bins,shift,block",
                         [(16, 0, 256), (64, 4, 512), (256, 8, 1024),
                          (8, 0, 128), (2, 16, 256), (256, 24, 128)])
def test_block_histograms_match_reference(ref_mode, n_bins, shift, block):
    keys = _keys(n_bins + shift, block * 4)
    want = np.asarray(R.block_histograms(jnp.asarray(keys), n_bins=n_bins,
                                         shift=shift, block=block,
                                         mode=ref_mode))
    got = T.block_histograms(torch.from_numpy(keys), n_bins=n_bins,
                             shift=shift, block=block)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == block * 4               # conservation


@pytest.mark.parametrize("shift", [0, 8, 16])
def test_block_histograms_negative_keys_use_a_logical_shift(shift):
    keys = _keys(shift, 1024)
    got = T.block_histograms(torch.from_numpy(keys), n_bins=64,
                             shift=shift, block=256)
    digits = (keys.view(np.uint32) >> shift) & 63
    np.testing.assert_array_equal(got.numpy().sum(0),
                                  np.bincount(digits, minlength=64))


@pytest.mark.parametrize("ref_mode", ["ref", "interpret"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_padded_bin_counts_match_reference(ref_mode, n):
    for shift in (0, 8, 16):
        keys = _keys(n + shift, n)
        want = np.asarray(R.padded_bin_counts(
            jnp.asarray(keys), n_bins=64, shift=shift, block=256,
            mode=ref_mode))
        got = T.padded_bin_counts(torch.from_numpy(keys), n_bins=64,
                                  shift=shift, block=256)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_padded_bin_counts_empty():
    got = T.padded_bin_counts(torch.zeros((0,), dtype=torch.int32),
                              n_bins=16, block=256)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.zeros(16))


@pytest.mark.parametrize("n,shift", [(1000, 0), (2048, 4), (777, 8)])
def test_radix_partition_matches_reference(n, shift):
    keys = _keys(n, n, 0, 1 << 16)
    vals = np.arange(n, dtype=np.float32)
    wk, wv, ws = R.radix_partition(jnp.asarray(keys), jnp.asarray(vals),
                                   n_bins=16, shift=shift, block=256,
                                   mode="ref")
    gk, gv, gs = T.radix_partition(torch.from_numpy(keys),
                                   torch.from_numpy(vals), n_bins=16,
                                   shift=shift, block=256)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_block_histograms_refuse_unaligned_input():
    with pytest.raises(ValueError, match="divisible"):
        block_histograms_ref(torch.zeros(300, dtype=torch.int32), n_bins=8,
                             shift=0, block=256)


def test_forced_cuda_mode_on_cpu_keys_raises_and_counts_nothing():
    before = dict(common.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        T.block_histograms(torch.zeros(256, dtype=torch.int32), n_bins=8,
                           block=256, mode="cuda")
    assert common.LAUNCHES == before
