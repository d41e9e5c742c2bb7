"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device each test skips (a CUDA kernel has
no CPU mode). This file imports neither jax nor the reference package, so
it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from _agg_order import kernel_order_sums, q18_like
from _join_cases import CASES, case
from _radix_cases import CASES as RADIX_CASES
from _radix_cases import case as radix_case
from _scan_order import kernel_order_scan
from repro_torch.analytics import join
from repro_torch.analytics.columnar import segment_sum, take_rows
from repro_torch.kernels import common
from repro_torch.kernels.hash_aggregate import (hash_aggregate,
                                                hash_aggregate_multi)
from repro_torch.kernels.join_probe import join_probe
from repro_torch.kernels.join_probe.ref import join_probe_ref
from repro_torch.kernels.radix_partition.ops import (block_histograms,
                                                     padded_bin_counts)
from repro_torch.kernels.radix_partition.ref import block_histograms_ref
from repro_torch.kernels.radix_probe import radix_probe
from repro_torch.kernels.radix_probe.ref import radix_probe_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_chunked,
                                                     attention_naive)
from repro_torch.kernels.rglru_scan import linear_scan
from repro_torch.kernels.rglru_scan.ops import CHUNK as SCAN_RUN
from repro_torch.kernels.rglru_scan.ops import _launch as scan_launch
from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential
from repro_torch.kernels.rwkv6_scan import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref


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


def _agg_case(name):
    """(ids (P, T) int32, vals (P, T, C) float32, n_bins) as numpy arrays."""
    kind, _, arg = name.partition(" ")
    rng = np.random.RandomState(len(name))
    if kind == "C":                      # private tables, C = 1..8
        C = int(arg)
        ids = rng.randint(-3, 131, (2, 5000)).astype(np.int32)
        return ids, (rng.randn(2, 5000, C) * 100).astype(np.float32), 128
    if kind == "owned":                  # one shared table, bins by warp
        ids = rng.randint(-3, 5003, (2, 9_999)).astype(np.int32)
        return ids, (rng.randn(2, 9_999, 3) * 100).astype(np.float32), 5000
    if kind == "tile-edge":              # two bin tiles at C = 8
        ids = rng.randint(4_900, 5_100, (1, 20_000)).astype(np.int32)
        return ids, (rng.randn(1, 20_000, 8) * 100).astype(np.float32), 6000
    if kind == "one-bin":                # every row in one bin
        n_bins = int(arg)
        ids = np.full((2, 50_000), 11, np.int32)
        vals = (rng.randint(1, 51, (2, 50_000, 2))
                * rng.uniform(900, 2100, (2, 50_000, 1))).astype(np.float32)
        return ids, vals, n_bins
    if kind == "zeros":                  # out of range, +-0 rows and values
        ids = rng.randint(-5, 305, (3, 4097)).astype(np.int32)
        vals = (rng.randn(3, 4097, 3) * 100).astype(np.float32)
        vals[:, ::3] = -0.0
        vals[:, 1::7, 1] = -0.0
        vals[:, 2::11] = 0.0
        return ids, vals, 300
    if kind == "ragged":                 # T not a multiple of the batch
        T = int(arg)
        ids = rng.randint(0, 64, (1, T)).astype(np.int32)
        return ids, (rng.randn(1, T, 2) * 100).astype(np.float32), 64
    ids, vals = q18_like(7)              # "q18": two partitions of q18's,
    ids2, vals2 = q18_like(8, in_order=kind == "q18-in-order")
    return np.stack([ids, ids2]), np.stack([vals, vals2]), 23_552


def _f64_sums(ids, vals, n_bins):
    """(P, n_bins, C) float64 sums; ids out of range add nothing."""
    P, T, C = vals.shape
    slot = np.where((ids >= 0) & (ids < n_bins), ids, n_bins)
    flat = (slot + (n_bins + 1) * np.arange(P)[:, None]).reshape(-1)
    out = torch.zeros((P * (n_bins + 1), C), dtype=torch.float64)
    out.index_add_(0, torch.from_numpy(flat),
                   torch.from_numpy(vals.reshape(-1, C).astype(np.float64)))
    return out.reshape(P, n_bins + 1, C)[:, :n_bins]


AGG_CASES = ([f"C {c}" for c in range(1, 9)]
             + ["owned", "tile-edge", "one-bin 128", "one-bin 23552",
                "zeros", "ragged 1025", "ragged 3000", "q18",
                "q18-in-order"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", AGG_CASES)
def test_cuda_hash_aggregate_gives_the_order_models_bits(dev, name):
    ids, vals, n_bins = _agg_case(name)
    ids_t = torch.from_numpy(ids).to(dev)
    vals_t = torch.from_numpy(vals).to(dev)
    a = hash_aggregate_multi(ids_t, vals_t, n_bins=n_bins)
    b = hash_aggregate_multi(ids_t, vals_t, n_bins=n_bins)
    assert torch.equal(a, b)                      # two runs, the same bits
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    model = kernel_order_sums(ids_t, vals_t, n_bins, n_sms=n_sms)
    assert torch.equal(a.cpu().view(torch.int32), model.view(torch.int32))
    # within 1e-5 of the float64 sums, relative to the sums of |values|
    want = _f64_sums(ids, vals, n_bins)
    scale = _f64_sums(ids, np.abs(vals), n_bins)
    assert bool(((a.cpu().double() - want).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
def test_cuda_hash_aggregate_paths_agree_on_renamed_bins(dev):
    """Renaming the bins renames the sums, bit for bit: in order, most of
    a batch's bins are held by two groups (runs across a group's edge) and
    go the ordered way; renamed at random nearly none are."""
    ids, vals, n_bins = _agg_case("q18-in-order")
    perm = np.random.RandomState(5).permutation(n_bins)
    v = torch.from_numpy(vals).to(dev)
    a = hash_aggregate_multi(torch.from_numpy(ids).to(dev), v,
                             n_bins=n_bins).cpu()
    b = hash_aggregate_multi(torch.from_numpy(perm[ids].astype(np.int32))
                             .to(dev), v, n_bins=n_bins).cpu()
    assert torch.equal(b[:, torch.from_numpy(perm)].view(torch.int32),
                       a.view(torch.int32))


@pytest.mark.cuda
def test_cuda_hash_aggregate_zero_rows_change_nothing(dev):
    """A row whose values are all +-0 gives the bits of a row whose id is
    out of range, and no sum is -0."""
    ids, vals, n_bins = _agg_case("zeros")
    zero = ~(vals != 0).any(axis=2)
    moved = np.where(zero, n_bins + 9, ids).astype(np.int32)
    got = [hash_aggregate_multi(torch.from_numpy(i).to(dev),
                                torch.from_numpy(vals).to(dev),
                                n_bins=n_bins).cpu() for i in (ids, moved)]
    assert torch.equal(got[0].view(torch.int32), got[1].view(torch.int32))
    assert not bool(torch.signbit(got[0][got[0] == 0]).any())


@pytest.mark.cuda
def test_cuda_hash_aggregate_splits_wide_columns(dev):
    rng = np.random.RandomState(11)
    ids = torch.from_numpy(rng.randint(0, 100, (2, 3000)).astype(np.int32))
    vals = torch.from_numpy((rng.randn(2, 3000, 11) * 100)
                            .astype(np.float32))
    before = common.LAUNCHES["hash_aggregate_multi"]
    got = hash_aggregate_multi(ids.to(dev), vals.to(dev), n_bins=100)
    assert common.LAUNCHES["hash_aggregate_multi"] == before + 2
    want = hash_aggregate_multi(ids, vals, n_bins=100)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,T,n_bins", [(8, 4096, 128), (64, 9000, 1024),
                                        (1, 50_000, 20_000)])
def test_cuda_hash_aggregate_wrapper_is_one_column_of_the_multi(
        dev, P, T, n_bins):
    rng = np.random.RandomState(P + n_bins)
    ids = torch.from_numpy(rng.randint(-2, n_bins + 2, (P, T))
                           .astype(np.int32)).to(dev)
    vals = torch.from_numpy((rng.randn(P, T) * 100).astype(np.float32)
                            ).to(dev)
    before = common.LAUNCHES["hash_aggregate_multi"]
    got = hash_aggregate(ids, vals, n_bins=n_bins)
    assert common.LAUNCHES["hash_aggregate_multi"] == before + 1
    multi = hash_aggregate_multi(ids, vals[..., None].contiguous(),
                                 n_bins=n_bins)
    assert torch.equal(got.view(torch.int32),
                       multi[..., 0].view(torch.int32))
    want = hash_aggregate(ids.cpu(), vals.cpu(), n_bins=n_bins)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
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


def _f32_bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_join_probe_equals_plain_bits(dev, name):
    """The hashed probe against the plain version, vals bit for bit (a
    -0.0 payload included) and found, on the edge cases of _join_cases."""
    bk, bv, pk = (torch.from_numpy(x).to(dev) for x in case(name))
    before = common.LAUNCHES["join_probe"]
    got_v, got_f = join_probe(bk, bv, pk)
    assert common.LAUNCHES["join_probe"] == before + 1
    want_v, want_f = join_probe_ref(bk, bv, pk)
    assert torch.equal(_f32_bits(got_v), _f32_bits(want_v))
    assert torch.equal(got_f, want_f)
    again_v, _ = join_probe(bk, bv, pk)
    assert torch.equal(_f32_bits(again_v), _f32_bits(got_v))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "last", "padding around"])
def test_cuda_join_probe_rejects_duplicate_build_keys(dev, where):
    bk, bv, pk = case("no padding, probed with -1")
    bk = bk.copy()
    if where == "first":
        bk[0, 1] = bk[0, 0]
    elif where == "last":
        bk[2, -2] = bk[2, -1]
    else:
        bk[1, :100] = -1                      # duplicate -1s are padding
        bk[1, 200] = bk[1, 300]
    with pytest.raises(ValueError, match="twice"):
        join_probe(*(torch.from_numpy(x).to(dev) for x in (bk, bv, pk)))


@pytest.mark.cuda
def test_cuda_join_probe_takes_repeated_padding(dev):
    """Many -1 build slots are padding, not duplicates."""
    bk, bv, pk = case("all-padding partition")
    got = join_probe(*(torch.from_numpy(x).to(dev) for x in (bk, bv, pk)))
    want = join_probe(*(torch.from_numpy(x) for x in (bk, bv, pk)))
    assert torch.equal(_f32_bits(got[0]).cpu(), _f32_bits(want[0]))
    assert torch.equal(got[1].cpu(), want[1])


def _radix_args(dev, name, bits=10):
    bk, bv, pk = (torch.from_numpy(x).to(dev)
                  for x in radix_case(name, scale=100))
    index = join.build_radix_index(bk, bv, bits=bits)
    return (index.sorted_keys, index.sorted_vals, index.bucket_starts,
            index.bits, pk)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RADIX_CASES))
def test_cuda_radix_probe_equals_plain_bits(dev, name):
    """The kernel against the plain version on the card, vals bit for bit
    (a -0.0 payload included) and found, on the edge cases of
    _radix_cases (the Blanas draws at 200K x 3.2M)."""
    args = _radix_args(dev, name)
    before = common.LAUNCHES["radix_probe"]
    got_v, got_f = radix_probe(*args)
    assert common.LAUNCHES["radix_probe"] == before + (args[-1].numel() > 0)
    want_v, want_f = radix_probe_ref(*args)
    assert torch.equal(_f32_bits(got_v), _f32_bits(want_v))
    assert torch.equal(got_f, want_f)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 4, 13, 16])
def test_cuda_radix_probe_takes_any_bucket_count(dev, bits):
    """One bucket, long runs, fewer staged levels (2 at 2^13 buckets) and
    none (2^16 buckets)."""
    args = _radix_args(dev, "blanas with misses", bits=bits)
    got_v, got_f = radix_probe(*args)
    want_v, want_f = radix_probe_ref(*args)
    assert torch.equal(_f32_bits(got_v), _f32_bits(want_v))
    assert torch.equal(got_f, want_f)


@pytest.mark.cuda
def test_cuda_radix_probe_rejects_what_it_cannot_take(dev):
    sk, sv, starts, bits, pk = _radix_args(dev, "blanas")
    with pytest.raises(TypeError, match="int32"):
        radix_probe(sk, sv, starts, bits, pk.long())
    with pytest.raises(ValueError, match="shape"):
        radix_probe(sk, sv, starts[:-1], bits, pk)
    with pytest.raises(ValueError, match="contiguous"):
        radix_probe(sk, sv, starts, bits, pk[::2])


@pytest.mark.cuda
def test_cuda_radix_index_join_launches_the_kernel_once(dev):
    """One W4 radix join is one launch; its count and checksum are those
    of the plain version's outputs on the card, summed the same way, and
    the count is the CPU's."""
    bk, bv, pk = (torch.from_numpy(x).to(dev)
                  for x in radix_case("blanas with misses", scale=100))
    before = common.LAUNCHES["radix_probe"]
    n, total = join.index_join(bk, bv, pk, "radix")
    assert common.LAUNCHES["radix_probe"] == before + 1
    index = join.build_radix_index(bk, bv)
    vals, found = radix_probe_ref(index.sorted_keys, index.sorted_vals,
                                  index.bucket_starts, index.bits, pk)
    assert int(n) == int(found.sum())
    assert torch.equal(_f32_bits(total), _f32_bits(vals.sum()))
    cpu_n, _ = join.index_join(bk.cpu(), bv.cpu(), pk.cpu(), "radix")
    assert int(n) == int(cpu_n)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", [2, 8, 64, 256])
@pytest.mark.parametrize("shift", [0, 8, 16, 24])
@pytest.mark.parametrize("block", [128, 256, 1024])
def test_cuda_block_histograms_equal_plain(dev, n_bins, shift, block):
    rng = np.random.RandomState(n_bins + shift + block)
    keys = rng.randint(-(1 << 31), (1 << 31) - 1, block * 37)
    keys = keys.astype(np.int32)
    keys[::5] = -1                             # the routing padding key
    k = torch.from_numpy(keys).to(dev)
    before = common.LAUNCHES["block_histograms"]
    got = block_histograms(k, n_bins=n_bins, shift=shift, block=block)
    assert common.LAUNCHES["block_histograms"] == before + 1
    want = block_histograms_ref(k, n_bins=n_bins, shift=shift, block=block)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    counts = padded_bin_counts(k[:block * 3 + 17], n_bins=n_bins,
                               shift=shift, block=block)
    digits = (keys[:block * 3 + 17].view(np.uint32) >> shift) & (n_bins - 1)
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  np.bincount(digits, minlength=n_bins))


def _hist_keys(seed, n):
    rng = np.random.RandomState(seed)
    keys = rng.randint(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64)
    keys = keys.astype(np.int32)
    keys[::5] = -1                             # the routing padding key
    return keys


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", [1 << k for k in range(9)])
@pytest.mark.parametrize("block", [1, 3, 100])
def test_cuda_block_histograms_take_any_block(dev, n_bins, block):
    """Every bin count of the kernel's two paths at block sizes off the
    int4 loads (1, 3) or off a warp's multiple (100), every shift."""
    k = torch.from_numpy(_hist_keys(n_bins + block, block * 333)).to(dev)
    for shift in (0, 1, 13, 24, 31):
        got = block_histograms(k, n_bins=n_bins, shift=shift, block=block)
        want = block_histograms_ref(k, n_bins=n_bins, shift=shift,
                                    block=block)
        assert got.dtype == torch.int32 and torch.equal(got, want), shift


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,block", [(1, 256), (1, 1000),
                                            (1 << 20, 16)])
@pytest.mark.parametrize("n_bins", [8, 32, 256])
def test_cuda_block_histograms_one_block_and_many(dev, n_blocks, block,
                                                  n_bins):
    """One histogram block (one warp of one CUDA block at work), and
    2^20 of them (the grid-stride loop past one wave)."""
    k = torch.from_numpy(_hist_keys(n_blocks, n_blocks * block)).to(dev)
    got = block_histograms(k, n_bins=n_bins, shift=3, block=block)
    want = block_histograms_ref(k, n_bins=n_bins, shift=3, block=block)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", [8, 256])
def test_cuda_block_histograms_read_unaligned_keys(dev, n_bins):
    """A view one int into its buffer is not 16-byte aligned: the kernel
    takes its scalar path and gives the aligned copy's counts."""
    buf = torch.from_numpy(_hist_keys(n_bins, 256 * 977 + 1)).to(dev)
    k = buf[1:]
    assert k.data_ptr() % 16 and k.is_contiguous()
    got = block_histograms(k, n_bins=n_bins, shift=0, block=256)
    want = block_histograms_ref(k, n_bins=n_bins, shift=0, block=256)
    assert torch.equal(got, want)
    assert torch.equal(got, block_histograms(k.clone(), n_bins=n_bins,
                                             shift=0, block=256))


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups,width", [(6_000_000, 6, 1),
                                            (6_000_000, 1_500_000, 2)])
def test_cuda_segment_sum_is_bit_stable(dev, n, groups, width):
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, groups, (n,), device=dev, generator=gen)
    vals = torch.rand((n, width), device=dev, generator=gen) * 1e4
    a = segment_sum(vals, ids, groups)
    b = segment_sum(vals, ids, groups)
    assert torch.equal(a, b)
    want = torch.zeros((groups, width), dtype=torch.float64, device=dev
                       ).index_add_(0, ids, vals.double())
    np.testing.assert_allclose(a.double().cpu().numpy(),
                               want.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 4, 6, 8])
def test_cuda_take_rows_is_row_indexing(dev, width):
    gen = torch.Generator(device=dev).manual_seed(width)
    x = torch.rand((1_000_000, width), device=dev, generator=gen)
    idx = torch.randint(0, x.shape[0], (999_999,), device=dev, generator=gen)
    assert torch.equal(take_rows(x, idx), x[idx])


# The attention and scan kernels against their plain versions: both sum
# the same float32 products in other orders, so 1e-5 absolute and relative.
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (14, 2), (10, 1)])
@pytest.mark.parametrize("S,window,q_offset", [(300, None, 0),
                                               (257, 37, 0),
                                               (130, 16, 70),
                                               (129, 1, 0)])
def test_cuda_flash_attention_matches_plain(dev, D, Hq, Hkv, S, window,
                                            q_offset):
    gen = torch.Generator(device=dev).manual_seed(D + Hq + S)
    Skv = S + q_offset
    q = torch.randn((2, S, Hq, D), device=dev, generator=gen)
    k = torch.randn((2, Skv, Hkv, D), device=dev, generator=gen)
    v = torch.randn((2, Skv, Hkv, D), device=dev, generator=gen)
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, window=window, q_offset=q_offset)
    assert common.LAUNCHES["flash_attention"] == before + 1
    want = attention_chunked(q, k, v, window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_cuda_flash_attention_rows_without_keys_are_zero(dev, D):
    gen = torch.Generator(device=dev).manual_seed(D)
    q = torch.randn((1, 70, 2, D), device=dev, generator=gen)
    k = torch.randn((1, 40, 1, D), device=dev, generator=gen)
    v = torch.randn((1, 40, 1, D), device=dev, generator=gen)
    # rows at positions 100..169 with a window of 50 see keys > 50: none
    got = flash_attention(q, k, v, window=50, q_offset=100)
    assert torch.equal(got, torch.zeros_like(got))
    # rows at 30..99: the first rows see some of the 40 keys, the rest none
    got = flash_attention(q, k, v, window=50, q_offset=30)
    want = attention_chunked(q, k, v, window=50, q_offset=30)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)
    assert torch.equal(got[:, 60:], torch.zeros_like(got[:, 60:]))


@pytest.mark.cuda
@pytest.mark.parametrize("off", ["q", "k", "v", "all"])
def test_cuda_flash_attention_takes_unaligned_inputs(dev, off):
    gen = torch.Generator(device=dev).manual_seed(7)

    def make(shape, cut):
        # a contiguous view one float past a fresh allocation's base
        n = int(np.prod(shape))
        t = torch.randn(n + 1, device=dev, generator=gen)
        return t[1:].view(shape) if cut else t[:n].view(shape)

    q = make((2, 131, 4, 128), off in ("q", "all"))
    k = make((2, 131, 2, 128), off in ("k", "all"))
    v = make((2, 131, 2, 128), off in ("v", "all"))
    assert any(t.data_ptr() % 16 for t in (q, k, v))
    got = flash_attention(q, k, v, window=40)
    want = attention_chunked(q, k, v, window=40)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 257, 4096])
@pytest.mark.parametrize("chunk", [SCAN_RUN, 64, 7])
def test_cuda_linear_scan_matches_plain(dev, S, chunk):
    gen = torch.Generator(device=dev).manual_seed(S + chunk)
    a = torch.rand((2, S, 300), device=dev, generator=gen) * 0.98 + 0.01
    b = torch.randn((2, S, 300), device=dev, generator=gen)
    before = common.LAUNCHES["rglru_scan"]
    got = (linear_scan(a, b) if chunk == SCAN_RUN
           else scan_launch(a, b, chunk=chunk))
    assert common.LAUNCHES["rglru_scan"] == before + 1
    want = linear_scan_sequential(a, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)


@pytest.mark.cuda
def test_cuda_linear_scan_carries_across_chunks(dev):
    """a = 1 everywhere: h is the running sum of b, so a carry lost or
    applied twice at a chunk boundary shows as a step there."""
    a = torch.ones((1, 200, 130), device=dev)
    b = torch.ones((1, 200, 130), device=dev)
    got = scan_launch(a, b, chunk=64)
    want = torch.arange(1, 201, device=dev, dtype=torch.float32)
    assert torch.equal(got[0], want[:, None].expand(200, 130))


def _scan_bits(x):
    return x.contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 255, 256, 257, 4097])
@pytest.mark.parametrize("D", [1, 31, 300, 2560])
def test_cuda_linear_scan_gives_the_order_models_bits(dev, S, D):
    """Bit-equal on two runs and to tests/_scan_order.py: one chunk and
    past it, a ragged last chunk, ragged channel tiles (the scalar path at
    D 1 and 31, the 16-byte path at 300 and 2560)."""
    gen = torch.Generator(device=dev).manual_seed(S * 7 + D)
    a = torch.rand((2, S, D), device=dev, generator=gen) * 0.98 + 0.01
    b = torch.randn((2, S, D), device=dev, generator=gen)
    got = linear_scan(a, b)
    assert torch.equal(_scan_bits(got), _scan_bits(linear_scan(a, b)))
    want = kernel_order_scan(a.cpu(), b.cpu(), SCAN_RUN)
    assert torch.equal(_scan_bits(got), _scan_bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_cuda_linear_scan_runs_give_the_order_models_bits(dev, chunk):
    gen = torch.Generator(device=dev).manual_seed(chunk)
    a = torch.rand((2, 1000, 130), device=dev, generator=gen) * 0.98 + 0.01
    b = torch.randn((2, 1000, 130), device=dev, generator=gen)
    got = scan_launch(a, b, chunk=chunk)
    want = kernel_order_scan(a.cpu(), b.cpu(), chunk)
    assert torch.equal(_scan_bits(got), _scan_bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [257, 4096])
def test_cuda_linear_scan_holds_near_one_decays(dev, S):
    """The RG-LRU's regime: a in [0.999, 0.99999], b scaled by
    sqrt(1 - a^2) as the RG-LRU scales it, where a run's product of a
    weighs most; within 1e-5 of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(S)
    a = torch.rand((2, S, 2560), device=dev, generator=gen) * 0.00099 + 0.999
    b = torch.randn((2, S, 2560), device=dev, generator=gen)
    b = b * torch.sqrt(1 - a.double() ** 2).float()
    got = linear_scan(a, b)
    want = linear_scan_sequential(a, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)
    assert torch.equal(_scan_bits(got),
                       _scan_bits(kernel_order_scan(a.cpu(), b.cpu(),
                                                    SCAN_RUN)))


# WKV6 against its plain version: the kernel takes the plain version's
# operations in its order, so y and the final state are equal bit for bit.
def _wkv6_inputs(dev, shape, w_lo, w_hi, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, S, H, N = shape
    r, k, v = (torch.randn(shape, device=dev, generator=gen) * 0.5
               for _ in range(3))
    w = w_lo + (w_hi - w_lo) * torch.rand(shape, device=dev, generator=gen)
    u = torch.randn((H, N), device=dev, generator=gen) * 0.5
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N", [(1, 1, 1, 16), (1, 1, 1, 64),
                                     (1, 4097, 1, 64), (2, 300, 3, 16),
                                     (2, 257, 4, 32), (1, 4097, 1, 16)])
@pytest.mark.parametrize("w_lo,w_hi", [(0.6, 0.99), (0.9996, 0.9998),
                                       (0.0, 0.01)])
def test_cuda_wkv6_equals_plain(dev, B, S, H, N, w_lo, w_hi):
    r, k, v, w, u = _wkv6_inputs(dev, (B, S, H, N), w_lo, w_hi, S + N)
    before = common.LAUNCHES["wkv6"]
    a = wkv6(r, k, v, w, u)
    b = wkv6(r, k, v, w, u)
    assert common.LAUNCHES["wkv6"] == before + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (B, S, H, N) and a[1].shape == (B, H, N, N)
    want = wkv6_ref(r, k, v, w, u)
    assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])


@pytest.mark.cuda
def test_cuda_wkv6_reads_strided_inputs_in_place(dev):
    """Heads cut from a wider (B, S, 2d) activation: the kernel reads them
    through their strides and gives the bits of contiguous copies."""
    B, S, H, N = 2, 100, 4, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = [torch.randn((B, S, 2 * H * N), device=dev, generator=gen) * 0.5
            for _ in range(4)]
    wide[3] = torch.sigmoid(wide[3])                      # decays in (0, 1)
    r, k, v, w = (x[..., :H * N].unflatten(-1, (H, N)) for x in wide)
    u = torch.randn((H, N), device=dev, generator=gen)
    assert not r.is_contiguous() and w.stride() == r.stride()
    got = wkv6(r, k, v, w, u)
    want = wkv6(*(x.contiguous() for x in (r, k, v, w)), u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_wkv6_rejects_other_head_sizes(dev):
    r, k, v, w, u = _wkv6_inputs(dev, (1, 8, 1, 48), 0.5, 0.9, 0)
    with pytest.raises(ValueError, match="head size"):
        wkv6(r, k, v, w, u)


@pytest.mark.cuda
@pytest.mark.parametrize("cut", ["base off 16 bytes", "odd time stride"])
def test_cuda_wkv6_reads_unaligned_strided_inputs(dev, cut):
    """Views whose base pointer or stride is no multiple of 16 bytes take
    the kernel's 4-byte copies and give the bits of contiguous copies."""
    B, S, H, N = 2, 77, 4, 64
    width = 2 * H * N + (1 if cut == "odd time stride" else 0)
    start = 1 if cut == "base off 16 bytes" else 0
    gen = torch.Generator(device=dev).manual_seed(1)
    wide = [torch.randn((B, S, width), device=dev, generator=gen) * 0.5
            for _ in range(4)]
    wide[3] = torch.sigmoid(wide[3])                      # decays in (0, 1)
    r, k, v, w = (x[..., start:start + H * N].unflatten(-1, (H, N))
                  for x in wide)
    u = torch.randn((H, N), device=dev, generator=gen)
    assert r.data_ptr() % 16 or r.stride(1) % 4
    got = wkv6(r, k, v, w, u)
    want = wkv6_ref(*(x.contiguous() for x in (r, k, v, w)), u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# W2 / W3 on one device, and telemetry on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("P,cf", [(8, 2.0), (64, 2.0), (8, 0.5)])
def test_cuda_hash_join_equals_plain(dev, P, cf):
    from repro_torch.analytics.datasets import blanas_join, to_tensors
    from repro_torch.analytics.join import hash_join
    jd = to_tensors(blanas_join(20_000, 320_000, seed=P), dev)
    args = (jd["build_keys"], jd["build_vals"], jd["probe_keys"])
    before = common.LAUNCHES["join_probe"]
    got = hash_join(*args, n_partitions=P, capacity_factor=cf)
    assert common.LAUNCHES["join_probe"] == before + 1
    want = hash_join(*args, n_partitions=P, capacity_factor=cf, mode="ref")
    assert int(got[0]) == int(want[0]) and int(got[2]) == int(want[2])
    assert got[1].view(torch.int32).item() == want[1].view(torch.int32).item()
    if cf >= 2.0:
        assert int(got[0]) == 320_000 and int(got[2]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,card,P,cf", [(200_000, 15_625, 64, 2.0),
                                         (100_000, 1000, 8, 0.5)])
def test_cuda_count_partitioned_equals_plain(dev, n, card, P, cf):
    from repro_torch.analytics.aggregate import count_direct, count_partitioned
    from repro_torch.analytics.datasets import to_tensors, zipf
    keys = to_tensors(zipf(n, card, seed=1), dev)["keys"]
    before = common.LAUNCHES["hash_aggregate_multi"]
    got, ovf = count_partitioned(keys, card, n_partitions=P,
                                 capacity_factor=cf)
    assert common.LAUNCHES["hash_aggregate_multi"] == before + 1
    want, want_ovf = count_partitioned(keys, card, n_partitions=P,
                                       capacity_factor=cf, mode="ref")
    assert int(ovf) == int(want_ovf)
    assert torch.equal(got, want)
    if int(ovf) == 0:
        assert torch.equal(got, count_direct(keys, card))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [None, 4])
def test_cuda_tracked_queries_give_untracked_bits(dev, shards):
    from repro_torch.analytics import planner, telemetry, tpch
    from repro_torch.core.config import PlacementPolicy
    data = tpch.generate(scale=0.01, seed=2, device=dev)
    ctx = planner.ExecutionContext(
        executor="kernel", join="kernel" if shards is None else None,
        n_shards=shards, exchange_impl="radix" if shards else "cost",
        dist_join="partitioned" if shards else None,
        policy=PlacementPolicy.INTERLEAVE if shards else None)
    try:
        for name, plan in tpch.LOGICAL_QUERIES.items():
            plain = planner.execute_plan(plan, data.tables, ctx)
            with telemetry.recording() as reg:
                cp = planner.compile_plan(plan, data.tables, ctx)
                tracked = cp(data.tables)
            assert set(tracked) == set(plain), name
            for k, v in plain.items():
                assert torch.equal(torch.nan_to_num(tracked[k], nan=-7.0),
                                   torch.nan_to_num(v, nan=-7.0)), (name, k)
            ps = reg.get(cp.cache_key)
            assert ps.executions == 1 and all(
                x >= 0 for ns in ps.nodes.values() for x in ns.last.values())
    finally:
        telemetry.registry().clear()


# ---------------------------------------------------------------------------
# the serving tier on pool streams (analytics/service/scheduler.py)
# ---------------------------------------------------------------------------
def _same_bits(got, want, label):
    assert set(got) == set(want), label
    for k, v in want.items():
        assert torch.equal(torch.nan_to_num(got[k], nan=-7.0),
                           torch.nan_to_num(v, nan=-7.0)), (label, k)


def _late_tables(dev, scale, seed):
    """TPC-H tables whose columns the default stream writes only after a
    ~50 ms spin: a pool stream that read them without waiting for the
    submitting stream would read memory not yet written."""
    from repro_torch.analytics import tpch
    data = tpch.generate(scale=scale, seed=seed, device=dev)
    torch.cuda._sleep(100_000_000)
    return {t: {c: a.clone() for c, a in cols.items()}
            for t, cols in data.tables.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("morsel_rows", [None, 50_000])
def test_cuda_served_on_pool_streams_equals_serial(dev, morsel_rows):
    """Submitted right after the tables were made, with no synchronize:
    each pool stream waits on the submitting stream's event. Served bits
    equal the serial run (whole plans, split-probe q3/q5/q18) and, for
    q1/q6's morsel merge (another float order than serial), a second
    round served on the finished tables."""
    from repro_torch.analytics import planner, tpch
    from repro_torch.analytics.service import (AnalyticsService,
                                               ServiceConfig)
    tables = _late_tables(dev, 0.05, 3)
    ctx = planner.ExecutionContext(executor="cost")
    rounds = []
    for _ in range(2):
        with AnalyticsService(ServiceConfig(
                n_pools=2, workers_per_pool=2,
                morsel_rows=morsel_rows)) as svc:
            rids = {n: tpch.submit_query(svc, n, tables, context=ctx)
                    for n in tpch.LOGICAL_QUERIES}
            results = svc.drain()
            st = svc.stats()
        assert st.completed == len(rids), st.describe()
        streams = {s for p in svc.scheduler.pools
                   for s in p.streams.values()}
        assert len(streams) == 2
        assert torch.cuda.current_stream(dev) not in streams
        rounds.append({n: results[r].value for n, r in rids.items()})
        torch.cuda.synchronize()
    for name, got in rounds[0].items():
        if morsel_rows is not None and name in ("q1", "q6"):
            want = rounds[1][name]
        else:
            want = tpch.run_query(name, tables, context=ctx)
        _same_bits(got, want, name)


@pytest.mark.cuda
def test_cuda_served_result_outlives_its_pool_stream(dev):
    """Serve, consume the result on the default stream behind a spin,
    drop it at once, serve again: the result's memory is not handed back
    to its pool's stream until the default stream has read it."""
    from repro_torch.analytics import planner, tpch
    from repro_torch.analytics.service import (AnalyticsService,
                                               ServiceConfig)
    data = tpch.generate(scale=0.05, seed=4, device=dev)
    ctx = planner.ExecutionContext(executor="cost")
    want = {n: tpch.run_query(n, data, context=ctx) for n in ("q1", "q3")}
    torch.cuda.synchronize()
    copies = []
    with AnalyticsService(ServiceConfig(n_pools=1,
                                        workers_per_pool=1)) as svc:
        for _ in range(3):
            rids = {n: tpch.submit_query(svc, n, data, context=ctx)
                    for n in want}
            results = svc.drain()
            torch.cuda._sleep(50_000_000)
            copies.append({n: {k: v.clone() for k, v in
                               results[rid].value.items()}
                           for n, rid in rids.items()})
            del results          # dropped while the clones are queued
    torch.cuda.synchronize()
    for got in copies:
        for n in want:
            _same_bits(got[n], want[n], n)


@pytest.mark.cuda
def test_cuda_split_probe_finalize_stays_on_the_card(dev):
    """The split-probe finalize walks a merged table with no tables of its
    own: every output, ``_overflow`` too, lies on the card."""
    from repro_torch.analytics import planner, tpch
    from repro_torch.analytics.service import (AnalyticsService,
                                               ServiceConfig)
    data = tpch.generate(scale=0.05, seed=5, device=dev)
    ctx = planner.ExecutionContext(executor="cost")
    with AnalyticsService(ServiceConfig(n_pools=2, workers_per_pool=1,
                                        morsel_rows=50_000)) as svc:
        rids = {n: tpch.submit_query(svc, n, data, context=ctx)
                for n in ("q3", "q5", "q18")}
        results = svc.drain()
        st = svc.stats()
    assert st.morsels > len(rids)                # the probes did split
    for name, rid in rids.items():
        value = results[rid].value
        assert value is not None, results[rid].error
        assert all(v.device.type == "cuda" for v in value.values()), name
        _same_bits(value, tpch.run_query(name, data, context=ctx), name)


@pytest.mark.cuda
def test_cuda_straggler_of_device_work_is_quarantined(dev, monkeypatch):
    """Pool 1 straggles by 80 ms of device work per morsel (a spin kernel
    on its stream, no host sleep; longer than the service's 50 ms wait
    tick, where the sweep runs): the morsel's end synchronizes the
    stream, so the EWMA sees the device time and the sweep quarantines
    the pool."""
    import time as time_mod
    from repro_torch.analytics import planner, tpch
    from repro_torch.analytics.service import (AnalyticsService,
                                               ServiceConfig,
                                               ServiceFaultInjector)
    slept = []
    real_sleep = time_mod.sleep
    monkeypatch.setattr(time_mod, "sleep",
                        lambda s: slept.append(s) or real_sleep(s))
    data = tpch.generate(scale=0.01, seed=6, device=dev)
    ctx = planner.ExecutionContext(executor="xla")
    want = tpch.run_query("q6", data, context=ctx)
    faults = ServiceFaultInjector(seed=3, straggle_pool=(1, 0.08))
    cfg = ServiceConfig(n_pools=2, workers_per_pool=1, batching=False,
                        steal=False, straggler_warmup=2,
                        straggler_threshold=4.0, faults=faults, retry=None)
    with AnalyticsService(cfg) as svc:
        rids = [tpch.submit_query(svc, "q6", data, context=ctx)
                for _ in range(14)]
        results = svc.drain()
        st = svc.stats()
        ewma = svc.scheduler.stats().pool_ewma_s
    assert 1 in st.quarantined_pools and st.dead_pools == (), st.describe()
    # the spin counts SM cycles at a rate measured once; the clock moves
    # with load, so the device time is near the 80 ms, not exact
    assert ewma[1] >= 0.04 and ewma[1] > 4 * ewma[0], ewma
    assert 0.08 not in slept                     # the delay was device work
    for rid in rids:
        _same_bits(results[rid].value, want, "q6")


# ---------------------------------------------------------------------------
# the cost-model calibration (analytics/dist_join_bench.py,
# scripts/calibrate_costs_torch.py)
# ---------------------------------------------------------------------------
def _plan_fields(res):
    """A dist_join_bench result without its timings."""
    if isinstance(res, dict):
        return {k: _plan_fields(v) for k, v in res.items()
                if not isinstance(v, float)}
    return res


@pytest.mark.cuda
def test_cuda_dist_join_bench_gives_the_cpus_plan_fields(dev):
    from repro_torch.analytics import dist_join_bench as DJB
    calls = {"sweep": (8192, [256, 4096], 4),
             "exchange": (1024, [1024, 8192], 4),
             "pushdown": (4096, 64, 4), "chain": (4096, 256, 4),
             "topk": (4096, 512, 8, 4)}
    for name, args in calls.items():
        fn = getattr(DJB, name)
        got, want = fn(*args, device=dev), fn(*args, device="cpu")
        assert _plan_fields(got) == _plan_fields(want), name
        times = [v for row in got.values()
                 for v in (row.values() if isinstance(row, dict) else [row])
                 if isinstance(v, float)]
        assert times and all(t > 0 for t in times), name


@pytest.mark.cuda
def test_cuda_calibration_writes_a_profile_that_loads(dev, tmp_path):
    import importlib.util
    import json
    import math
    import os
    from repro_torch.analytics import planner
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "calibrate_costs_torch",
        os.path.join(repo, "scripts", "calibrate_costs_torch.py"))
    calib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(calib)
    path = str(tmp_path / "profile.json")
    common.reset_launches()
    assert calib.main([
        "--rows", str(1 << 16), "--cols", "1", "2", "4", "--sweep-groups",
        "--groups-sweep", "512", "2048", "--dist", "--dist-devices", "4",
        "--dist-probe", str(1 << 14), "--dist-builds", "1024", "4096",
        "--exchange", "--exchange-build", "4096", "--exchange-probes",
        str(1 << 14), str(1 << 16), "--morsel", "--morsel-probes", "4096",
        "16384", "--out", path]) == 0
    torch.cuda.synchronize()
    assert common.LAUNCHES["hash_aggregate_multi"] > 0
    assert common.LAUNCHES["block_histograms"] > 0
    assert planner.current_cost_profile() == planner.CostProfile()
    with open(path) as f:
        raw = json.load(f)
    assert raw["backend"] == "cuda" and raw["card"]
    try:
        prof = planner.load_cost_profile(path)
        for field in ("fused_fixed", "fused_per_col", "sort_pass_factor",
                      "dist_route_factor", "radix_route_factor",
                      "dense_group_limit", "morsel_split_rows"):
            v = getattr(prof, field)
            assert math.isfinite(v) and v > 0, field
            assert v == raw[field], field
        assert prof.source == "cuda"
    finally:
        planner.set_cost_profile(None)
    assert planner.current_cost_profile() == planner.CostProfile()


# ---------------------------------------------------------------------------
# the hand-written TPC-H queries on CUDA tables (analytics/tpch.py)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["xla", "kernel"])
def test_cuda_imperative_queries_match_run_query(dev, executor):
    from repro_torch.analytics import tpch
    data = tpch.generate(scale=0.01, seed=3, device=dev)
    exact = ("o_orderkey", "count_order", "_count", "_overflow", "med_qty",
             "med_price")
    common.reset_launches()
    for name, query in tpch.QUERIES.items():
        got = query(data.tables, executor=executor)
        want = tpch.run_query(name, data, executor=executor)
        assert set(got) == set(want), name
        for k, w in want.items():
            g = got[k]
            assert g.device.type == "cuda" and g.shape == w.shape, (name, k)
            if k in exact or not w.is_floating_point():
                assert torch.equal(g, w), (name, k)
            else:
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                           atol=1e-3, rtol=1e-4,
                                           err_msg=f"{name}/{k}")
    torch.cuda.synchronize()
    launched = common.LAUNCHES["hash_aggregate_multi"] > 0
    assert launched == (executor == "kernel")


# Gradients through the three LM wrappers with the kernels' forwards,
# against plain autograd of independent versions on the card: the scan's
# reversed pass is the kernel too; the attention and WKV6 backward passes
# are plain code, as in the reference (WKV6 bit for bit: its backward is
# wkv6_ref's vjp and the kernel gives wkv6_ref's bits).
GRAD_REL = 1e-5


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [(1, 300, 10, 1, 256, 128),
                                                 (2, 200, 4, 2, 64, None)])
def test_cuda_flash_attention_grads_match_plain_autograd(dev, B, S, Hq, Hkv,
                                                         D, window):
    gen = torch.Generator(device=dev).manual_seed(S)
    ins = [torch.randn((B, S, h, D), device=dev, generator=gen)
           .requires_grad_() for h in (Hq, Hkv, Hkv)]
    g = torch.randn((B, S, Hq, D), device=dev, generator=gen)
    before = common.LAUNCHES["flash_attention"]
    got = torch.autograd.grad(flash_attention(*ins, window=window), ins, g)
    assert common.LAUNCHES["flash_attention"] == before + 1
    want = torch.autograd.grad(attention_naive(*ins, window=window), ins, g)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096, 2560), (2, 257, 130)])
def test_cuda_linear_scan_grads_match_plain_autograd(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(shape[1])
    a = (torch.rand(shape, device=dev, generator=gen) * 0.5 + 0.499
         ).requires_grad_()
    b = torch.randn(shape, device=dev, generator=gen).requires_grad_()
    g = torch.randn(shape, device=dev, generator=gen)
    before = common.LAUNCHES["rglru_scan"]
    got = torch.autograd.grad(linear_scan(a, b), (a, b), g)
    assert common.LAUNCHES["rglru_scan"] == before + 2   # forward, reversed
    want = torch.autograd.grad(linear_scan_sequential(a, b), (a, b), g)
    for x, y in zip(got, want):
        assert _rel_err(x, y) <= GRAD_REL


@pytest.mark.cuda
def test_cuda_wkv6_grads_equal_plain_autograd(dev):
    ins = [x.requires_grad_() for x in
           _wkv6_inputs(dev, (1, 64, 4, 64), 0.6, 0.99, 3)]
    y, s = wkv6(*ins)
    got = torch.autograd.grad(y.square().sum() + s.sum(), ins)
    y, s = wkv6_ref(*ins)
    want = torch.autograd.grad(y.square().sum() + s.sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _to(tree, d):
    return {k: (_to(v, d) if isinstance(v, dict) else v.to(d))
            for k, v in tree.items()}


@pytest.mark.cuda
def test_cuda_reduced_train_steps_match_the_cpu(dev):
    """Two steps of reduced recurrentgemma-2b (head dim 64, one of the
    attention kernel's) on the card with the kernels against the same
    steps on the CPU: losses and grad norms within 1e-4, parameters
    within 2 x the summed learning rates."""
    import dataclasses
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import LM_SHAPES, RunConfig, TrainConfig
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(REDUCED["recurrentgemma-2b"], head_dim=64)
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    train=TrainConfig(learning_rate=1e-3, warmup_steps=1))
    out, lrs = {}, 0.0
    for d in (torch.device("cpu"), dev):
        model = LMModel(arch, device=d)
        params = _to(LMModel(arch, device="cpu").init_params(0), d)
        state = adamw.init(params, cfg.train)
        step_fn = make_train_step(model, cfg, total_steps=2)
        before = dict(common.LAUNCHES)
        metrics = []
        for step in range(2):
            batch = {k: torch.from_numpy(v).to(d) for k, v in
                     synth_batch(arch, 2, 64, step=step).items()}
            params, state, m = step_fn(params, state, batch, step)
            metrics.append({k: float(v) for k, v in m.items()})
        launched = {k: common.LAUNCHES[k] - before[k] for k in before}
        out[d.type] = metrics, params, launched
    assert out["cpu"][2]["rglru_scan"] == 0
    assert out["cuda"][2]["flash_attention"] > 0
    assert out["cuda"][2]["rglru_scan"] > 0
    for mc, mg in zip(out["cpu"][0], out["cuda"][0]):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(mg[k], mc[k], rtol=1e-4)
        lrs += mc["lr"]

    def leaves(tree):
        for k in sorted(tree):
            v = tree[k]
            yield from (leaves(v) if isinstance(v, dict) else (v,))
    for a, b in zip(leaves(out["cpu"][1]), leaves(out["cuda"][1])):
        assert float((a - b.cpu()).abs().max()) <= 2 * lrs


# ---------------------------------------------------------------------------
# the moe, vlm and audio slice
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("D,Hq,Hkv", [(128, 32, 8), (128, 12, 2),
                                      (64, 32, 32)])
def test_cuda_flash_attention_at_the_families_heads(dev, D, Hq, Hkv):
    """phi3.5-moe's, qwen2-vl-2b's and musicgen-large's head layouts,
    causal with no window, at a small S."""
    gen = torch.Generator(device=dev).manual_seed(D + Hq)
    q = torch.randn((2, 333, Hq, D), device=dev, generator=gen)
    k = torch.randn((2, 333, Hkv, D), device=dev, generator=gen)
    v = torch.randn((2, 333, Hkv, D), device=dev, generator=gen)
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, scale=D ** -0.5)
    assert common.LAUNCHES["flash_attention"] == before + 1
    want = attention_chunked(q, k, v, scale=D ** -0.5)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)


def _moe_case(n_experts, factor, seed=0):
    import dataclasses
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.params import init_params
    from repro_torch.models import moe
    arch = REDUCED["phi3.5-moe"]
    arch = dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, n_experts=n_experts, capacity_factor=factor))
    gen = torch.Generator().manual_seed(seed)
    p = init_params(moe.moe_schema(arch), gen, torch.float32, "cpu")
    x = torch.randn((2, 64, arch.d_model), generator=gen)
    return arch, p, x


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [4.0, 1.25])
def test_cuda_moe_forward_matches_the_cpu(dev, factor):
    """The layer on the card against the same call on the CPU (at 1.25
    some assignments drop), and the same bits on two runs."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, p, x = _moe_case(8, factor)
    want, want_aux = moe.moe_forward(p, x, arch)
    pd = _to(p, dev)
    got, aux = moe.moe_forward(pd, x.to(dev), arch)
    again, _ = moe.moe_forward(pd, x.to(dev), arch)
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.cuda
def test_cuda_moe_forward_sharded_on_a_virtual_mesh(dev):
    """The expert-parallel path on 4 virtual shards of the card against
    ``moe_forward`` on the card (factor 4: neither drops) and against the
    same mesh on the CPU."""
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, p, x = _moe_case(8, 4.0, seed=1)
    n, el, sl = 4, 2, x.shape[1] // 4

    def run(d):
        pd, xd = _to(p, d), x.to(d)
        inputs = [({"router": pd["router"],
                    **{k: pd[k][i * el:(i + 1) * el]
                       for k in ("w_gate", "w_up", "w_down")}},
                   xd[:, i * sl:(i + 1) * sl]) for i in range(n)]
        outs = VirtualMesh(n, d, timeout=60).run(
            lambda comm, a: moe.moe_forward_sharded(comm, a[0], a[1], arch),
            inputs)
        return torch.cat([y for y, _ in outs], dim=1), outs[0][1]

    got, aux = run(dev)
    full, full_aux = moe.moe_forward(_to(p, dev), x.to(dev), arch)
    cpu, cpu_aux = run(torch.device("cpu"))
    for want in (full, cpu):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
    for want in (full_aux, cpu_aux):
        np.testing.assert_allclose(float(aux), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# MLA and deepseek-v3
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("S", [333, 64])
def test_cuda_flash_attention_at_mla_head_dim(dev, S):
    """deepseek-v3's MLA call: q and k at head dim 128 + 64 = 192, v
    zero-padded from 128 to 192, causal, its scale; the padded columns of
    the output are exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(192 + S)
    q = torch.randn((2, S, 8, 192), device=dev, generator=gen)
    k = torch.randn((2, S, 8, 192), device=dev, generator=gen)
    v = torch.nn.functional.pad(
        torch.randn((2, S, 8, 128), device=dev, generator=gen), (0, 64))
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, scale=192 ** -0.5)
    assert common.LAUNCHES["flash_attention"] == before + 1
    want = attention_chunked(q, k, v, scale=192 ** -0.5)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL)
    assert torch.equal(got[..., 128:], torch.zeros_like(got[..., 128:]))


def _small_mla_arch():
    """Reduced deepseek-v3 with the published MLA head widths (rope-free
    128, rotary 64, v 128), so its attention runs the kernel at D 192 (the
    reduced config's 16 + 8 = 24 is not one of the kernel's head dims)."""
    import dataclasses
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import MLAConfig
    return dataclasses.replace(
        REDUCED["deepseek-v3"], n_heads=2, n_kv_heads=2,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))


@pytest.mark.cuda
def test_cuda_small_deepseek_matches_the_cpu(dev):
    """The 4-layer MLA + MoE + MTP plan on the card with the kernel against
    the same model on the CPU: logits within 1e-4 (test_torch_lm.py's
    model bound), the losses within 1e-5 relative, absorbed decode
    against forward within 2e-3."""
    from repro_torch.models.lm import LMModel
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = _small_mla_arch()
    cpu = LMModel(arch, device="cpu", cache_dtype=torch.float32)
    card = LMModel(arch, device=dev, cache_dtype=torch.float32)
    params = cpu.init_params(0)
    pd = _to(params, dev)
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(1, arch.vocab_size, (2, 33), generator=gen)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    batch_d = {k: v.to(dev) for k, v in batch.items()}
    with torch.no_grad():
        want, _, _ = cpu.forward(params, batch)
        before = common.LAUNCHES["flash_attention"]
        got, _, _ = card.forward(pd, batch_d)
        assert common.LAUNCHES["flash_attention"] == before + arch.n_layers
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-4)
        want_l, want_m = cpu.loss_fn(params, batch)
        got_l, got_m = card.loss_fn(pd, batch_d)
        for k in ("ce", "aux", "mtp"):
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                       rtol=1e-5)
        np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
        cache = card.init_cache(2, 33)
        for step in range(32):
            logits, cache = card.decode_step(
                pd, cache, {"tokens": batch_d["tokens"][:, step:step + 1]})
            np.testing.assert_allclose(logits[:, 0].cpu().numpy(),
                                       got[:, step].cpu().numpy(),
                                       atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4])
def test_cuda_compression_is_its_cpu_bits(dev, n):
    """Quantization and the compressed psum on a virtual mesh of CUDA
    tensors give the CPU's bits: q, scales, synced gradients, residuals
    (the division by n is by a device tensor, not a reciprocal)."""
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.optim import compression
    rng = np.random.RandomState(n)
    g = [{"a": torch.from_numpy((rng.randn(37, 29) * np.exp(
        rng.randn(37, 29))).astype(np.float32)),
          "b": torch.from_numpy(rng.randn(3, 700).astype(np.float32))}
         for _ in range(n)]
    e = [{k: torch.from_numpy((rng.randn(*v.shape) * 1e-2).astype(
        np.float32)) for k, v in gi.items()} for gi in g]
    q_c, s_c = compression.quantize_int8(g[0]["a"])
    q_d, s_d = compression.quantize_int8(g[0]["a"].to(dev))
    assert torch.equal(q_d.cpu(), q_c) and torch.equal(s_d.cpu(), s_c)
    out = {}
    for d in (torch.device("cpu"), dev):
        # copies: the residuals are updated in place
        inputs = [(_to(gi, d), {k: v.clone().to(d) for k, v in ei.items()})
                  for gi, ei in zip(g, e)]
        out[d.type] = VirtualMesh(n, d, timeout=60).run(
            lambda comm, a: compression.compressed_psum(a[0], comm, a[1]),
            inputs)
    for (sc, ec), (sd, ed) in zip(out["cpu"], out["cuda"]):
        for k in ("a", "b"):
            assert torch.equal(sd[k].cpu(), sc[k]), k
            assert torch.equal(ed[k].cpu(), ec[k]), k


@pytest.mark.cuda
def test_cuda_dp_steps_on_a_virtual_mesh_match_the_cpu(dev):
    """(B) at a small size: reduced recurrentgemma-2b (head dim 64) on 4
    virtual ranks of the card, 2 steps with and without compression,
    against the same on the CPU: losses and grad norms within 1e-4,
    parameters within 2 x the summed learning rates; without compression
    the 4 ranks' step equals one rank's on the whole batch within 1e-5."""
    import dataclasses
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import (LM_SHAPES, RunConfig,
                                         ShardingConfig, TrainConfig)
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.runtime import dp_step, train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(REDUCED["recurrentgemma-2b"], head_dim=64)
    for compress in (False, True):
        cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                        sharding=ShardingConfig(gradient_compression=compress),
                        train=TrainConfig(learning_rate=1e-3, warmup_steps=1))
        out, lrs = {}, 0.0
        for d in (torch.device("cpu"), dev):
            model = LMModel(arch, device=d)
            params = _to(LMModel(arch, device="cpu").init_params(0), d)
            state = adamw.init(params, cfg.train)
            mesh = VirtualMesh(4, d, timeout=60)
            errors = dp_step.init_error_feedback(params, mesh)
            step_fn = dp_step.make_dp_train_step(model, cfg, mesh,
                                                 total_steps=2)
            before = dict(common.LAUNCHES)
            metrics = []
            for step in range(2):
                batch = {k: torch.from_numpy(v).to(d) for k, v in
                         synth_batch(arch, 4, 64, step=step).items()}
                params, state, errors, m = step_fn(params, state, errors,
                                                   batch, step)
                metrics.append({k: float(v) for k, v in m.items()})
            launched = {k: common.LAUNCHES[k] - before[k] for k in before}
            out[d.type] = metrics, params, launched
        assert out["cuda"][2]["flash_attention"] > 0
        assert out["cuda"][2]["rglru_scan"] > 0
        for mc, mg in zip(out["cpu"][0], out["cuda"][0]):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(mg[k], mc[k], rtol=1e-4)
            lrs += mc["lr"]

        def leaves(tree):
            for k in sorted(tree):
                v = tree[k]
                yield from (leaves(v) if isinstance(v, dict) else (v,))
        for a, b in zip(leaves(out["cpu"][1]), leaves(out["cuda"][1])):
            assert float((a - b.cpu()).abs().max()) <= 2 * lrs
    # 4 ranks against one rank on the whole batch, on the card
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    train=TrainConfig(learning_rate=1e-3, warmup_steps=1))
    model = LMModel(arch, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synth_batch(arch, 4, 64, step=0).items()}
    got = []
    for fn in (train_loop.make_train_step(model, cfg),
               dp_step.make_dp_train_step(model, cfg,
                                          VirtualMesh(4, dev, timeout=60))):
        params = _to(LMModel(arch, device="cpu").init_params(0), dev)
        state = adamw.init(params, cfg.train)
        args = (params, state, batch, 1) if len(got) == 0 else \
            (params, state, None, batch, 1)
        got.append(float(fn(*args)[-1]["loss"]))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5)


@pytest.mark.cuda
def test_cuda_dist_mesh_of_one_rank_over_nccl(dev, tmp_path):
    """The communicator over NCCL at world size 1: every collective on
    CUDA tensors gives a one-rank virtual mesh's bits, and the tensors
    stay on the card."""
    import torch.distributed as dist
    from repro_torch.core import dist as tdist
    from repro_torch.core.vmesh import VirtualMesh
    x = torch.randn(8, 5, device=dev).t()
    ints = torch.randint(-9, 9, (8, 5), device=dev, dtype=torch.int32)
    ops = ("psum", "pmax", "pmin", "psum_scatter", "all_gather",
           "all_to_all")
    want = VirtualMesh(1, dev).run(
        lambda comm, _: {(op, i): getattr(comm, op)(t)
                         for op in ops for i, t in enumerate((x, ints))},
        [None])[0]
    with tdist.process_group("nccl", rank=0, world_size=1,
                             store=dist.FileStore(str(tmp_path / "s"), 1),
                             timeout=120) as mesh:
        for op in ops:
            for i, t in enumerate((x, ints)):
                got = getattr(mesh.comm, op)(t)
                assert got.device.type == "cuda"
                assert torch.equal(got, want[(op, i)]), (op, i)
        assert mesh.comm.psum(x).stride() == x.stride()
        assert set(mesh.comm.traffic) == {"all_gather_into_tensor",
                                          "all_reduce", "all_to_all_single"}
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_cuda_kernel_operators_give_the_launch_bits(dev):
    """Each LM kernel through its ``torch.library`` operator (the
    wrappers' path) gives the bits of the same C launch made directly,
    the way the wrappers launched before the operators, and counts one
    launch."""
    from repro_torch.kernels.common import stream_handle
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as sc_ops
    from repro_torch.kernels.rwkv6_scan import ops as wk_ops
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    q, k, v = rand(2, 300, 8, 128), rand(2, 300, 2, 128), rand(2, 300, 2, 128)
    before = common.LAUNCHES["flash_attention"]
    got = fa_ops._launch(q, k, v, causal=True, window=100, q_offset=5,
                         scale=0.09)
    assert common.LAUNCHES["flash_attention"] == before + 1
    want = torch.empty_like(q)
    assert fa_ops._bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          want.data_ptr(), 2, 300, 300, 8, 2, 128, 5, 1, 100,
                          0.09, stream_handle(dev)) == 0
    assert torch.equal(got, want)

    a, b = torch.rand(2, 700, 256, device=dev, generator=gen), rand(2, 700,
                                                                    256)
    before = common.LAUNCHES["rglru_scan"]
    got = sc_ops._launch(a, b)
    assert common.LAUNCHES["rglru_scan"] == before + 1
    want = torch.empty_like(a)
    nc = -(-700 // (sc_ops.WARPS * sc_ops.CHUNK))
    words = torch.empty(2 * nc * 256 + 1, dtype=torch.int64, device=dev)
    assert sc_ops._bind()(a.data_ptr(), b.data_ptr(), want.data_ptr(), None,
                          words.data_ptr(), 2, 700, 256, sc_ops.CHUNK,
                          stream_handle(dev)) == 0
    assert torch.equal(got, want)

    r, kk, vv = rand(2, 65, 4, 64), rand(2, 65, 4, 64), rand(2, 65, 4, 64)
    w = torch.rand(2, 65, 4, 64, device=dev, generator=gen)
    u = rand(4, 64)
    before = common.LAUNCHES["wkv6"]
    y, s = wk_ops._launch(r, kk, vv, w, u)
    assert common.LAUNCHES["wkv6"] == before + 1
    wy = torch.empty_like(r)
    ws = torch.empty(2, 4, 64, 64, device=dev)
    sb, ss, sh, _ = r.stride()
    assert wk_ops._bind()(r.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                          w.data_ptr(), u.data_ptr(), wy.data_ptr(),
                          ws.data_ptr(), 2, 65, 4, 64, sb, ss, sh,
                          stream_handle(dev)) == 0
    assert torch.equal(y, wy) and torch.equal(s, ws)


@pytest.mark.cuda
def test_cuda_bf16_attention_runs_the_kernel_in_float32(dev):
    """bfloat16 q, k, v (bfloat16 parameters) go through the kernel as
    float32 copies and the backward recomputes from the same copies: the
    output and the gradients are the float32 route's on those, in
    bfloat16."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(1, 64, 4, 64, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    g = torch.randn(1, 64, 4, 64, device=dev, generator=gen).to(
        torch.bfloat16)
    before = common.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v)
    assert common.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16
    got.backward(g)
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = flash_attention(q32, k32, v32).to(torch.bfloat16)
    want.backward(g)
    assert torch.equal(got, want)
    for t, t32 in ((q, q32), (k, k32), (v, v32)):
        assert t.grad.dtype == torch.bfloat16
        assert torch.equal(t.grad, t32.grad.to(torch.bfloat16))


@pytest.mark.cuda
def test_cuda_fake_trace_allocates_and_launches_nothing(dev):
    """The dry run's trace on the card's stand-in (a fake cuda:0) of a
    train step through all three kernels' operators and of an rwkv
    prefill: the card's allocated and peak bytes stay as they were and no
    kernel launches. The first ``fake_card`` of the process makes
    FakeTensorMode's one 1-element set-up tensor before the gates."""
    import dataclasses
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import ShapeConfig, StepKind
    from repro_torch.launch import dryrun
    with dryrun.fake_card():       # FakeTensorMode's one-time set-up
        pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc = torch.cuda.memory_allocated()
    before = dict(common.LAUNCHES)
    mesh = dryrun.one_card_mesh()
    for arch, kind in (
            (dataclasses.replace(REDUCED["recurrentgemma-2b"], head_dim=64),
             StepKind.TRAIN),
            (REDUCED["rwkv6-7b"], StepKind.TRAIN),
            (REDUCED["rwkv6-7b"], StepKind.PREFILL)):
        shape = ShapeConfig("s", kind, 16, 2)
        out = dryrun.trace_cell(arch, shape, mesh,
                                dryrun.cell_config(arch, shape))
        assert out["trace_device"] == "cuda:0"
        assert out["flops"] > 0 and out["step_peak_bytes"] > 0
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == alloc
    assert torch.cuda.max_memory_allocated() == alloc
    assert common.LAUNCHES == before
