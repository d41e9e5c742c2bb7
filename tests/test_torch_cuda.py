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
from _scan_order import kernel_order_scan
from repro_torch.analytics.columnar import segment_sum
from repro_torch.kernels import common
from repro_torch.kernels.hash_aggregate import hash_aggregate_multi
from repro_torch.kernels.join_probe import join_probe
from repro_torch.kernels.join_probe.ref import join_probe_ref
from repro_torch.kernels.radix_partition.ops import (block_histograms,
                                                     padded_bin_counts)
from repro_torch.kernels.radix_partition.ref import block_histograms_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_chunked
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
