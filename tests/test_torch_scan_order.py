"""The orders of the rglru_scan and block_histograms CUDA kernels, on the CPU.

A CUDA kernel cannot run here, so its output is held to its models on a
card (``tests/test_torch_cuda.py``). What can be checked here is the design
each kernel's answers rest on:

* ``rglru_scan`` (``csrc/rglru_scan.cu``) is a single-pass scan chained
  along time: runs of ``CHUNK`` steps summarised from h = 0, folded in run
  order, each run applied from its entering h. The torch model of that
  order (``tests/_scan_order.py``, whose bits the kernel gives) equals
  ``linear_scan_sequential``'s bits inside the first run and holds the
  plain version and the reference within 1e-5, in the gate range of the
  tests and in the RG-LRU's own near-1 regime (b scaled by
  sqrt(1 - a^2), as the RG-LRU scales it), where a run's product of a
  carries most weight. With near-1 decays and b not scaled, h grows to
  ~100 and float32 itself parts every order from float64 by ~1e-4 (the
  sequential loop most); there the model is held to float64 at the
  sequence's scale.
* ``block_histograms`` (``csrc/radix_partition.cu``) counts in registers
  for n_bins <= 32: 4-bit counters per lane, flushed at most every 15 keys
  a lane through 16-bit fields summed over the warp; above 32 bins, peers
  from ``__match_any_sync`` into a per-warp table. A numpy model of both,
  over the kernel's lane assignment (int4 or scalar), gives
  ``block_histograms_ref``'s counts on the radix edge grid, and shows that
  a flush one key later would overflow a counter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _scan_order import kernel_order_scan
from repro.kernels.rglru_scan.kernel import rglru_scan_pallas
from repro.kernels.rglru_scan.ref import linear_scan_ref
from repro_torch.kernels.radix_partition.ref import block_histograms_ref
from repro_torch.kernels.rglru_scan.ops import CHUNK
from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
# a's range, and whether b is scaled by sqrt(1 - a^2) as the RG-LRU does
REGIMES = {"gate": (0.01, 0.99, False), "near-one": (0.999, 0.99999, True),
           "near-one unscaled": (0.999, 0.99999, False)}


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def scan_inputs(seed, shape, regime):
    rng = np.random.RandomState(seed)
    lo, hi, scaled = REGIMES[regime]
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    if scaled:
        b = (np.sqrt(1 - a.astype(np.float64) ** 2) * b).astype(np.float32)
    return a, b


def scan_f64(a, b):
    h = np.zeros((a.shape[0], a.shape[2]))
    out = np.empty(a.shape)
    for t in range(a.shape[1]):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("run", [1, 7, CHUNK, 64])
def test_scan_order_is_sequential_inside_the_first_run(run):
    a, b = (torch.from_numpy(x) for x in scan_inputs(run, (2, 3 * run + 5,
                                                           37), "gate"))
    got = kernel_order_scan(a, b, run)
    want = linear_scan_sequential(a, b)
    np.testing.assert_array_equal(bits(got[:, :run]), bits(want[:, :run]))
    # one run over the whole sequence is the sequential loop itself
    np.testing.assert_array_equal(bits(kernel_order_scan(a, b, a.shape[1])),
                                  bits(want))


@pytest.mark.parametrize("regime", ["gate", "near-one"])
@pytest.mark.parametrize("shape", [(2, 1000, 40), (1, 4096, 64)])
def test_scan_order_holds_plain_and_reference(regime, shape):
    a, b = scan_inputs(sum(shape), shape, regime)
    got = kernel_order_scan(torch.from_numpy(a), torch.from_numpy(b),
                            CHUNK).numpy()
    plain = linear_scan_sequential(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(got, plain, **SCAN_TOL)
    np.testing.assert_allclose(got, np.asarray(linear_scan_ref(ja, jb)),
                               **SCAN_TOL)
    np.testing.assert_allclose(
        got, np.asarray(rglru_scan_pallas(ja, jb, interpret=True)),
        **SCAN_TOL)


@pytest.mark.parametrize("shape", [(2, 1000, 40), (1, 4096, 64)])
def test_scan_order_holds_float64_at_scale_with_unscaled_b(shape):
    a, b = scan_inputs(sum(shape), shape, "near-one unscaled")
    want = scan_f64(a, b)
    scale = float(np.abs(want).max())
    got = kernel_order_scan(torch.from_numpy(a), torch.from_numpy(b),
                            CHUNK).numpy()
    plain = linear_scan_sequential(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
    assert scale > 50                                  # h grows here
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - want).max() <= np.abs(plain - want).max()


def test_scan_order_check_has_teeth():
    """The bits depend on the run: the model is not the sequential loop
    in disguise past the first run, and a carry lost at a run boundary is
    far outside the tolerance."""
    a, b = (torch.from_numpy(x) for x in scan_inputs(3, (2, 1000, 40),
                                                      "near-one"))
    got = kernel_order_scan(a, b, CHUNK)
    assert not np.array_equal(bits(got), bits(linear_scan_sequential(a, b)))
    assert not np.array_equal(bits(got),
                              bits(kernel_order_scan(a, b, CHUNK // 2)))
    lost = kernel_order_scan(a[:, CHUNK:], b[:, CHUNK:], CHUNK)
    assert float((lost - got[:, CHUNK:]).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# block_histograms: the counts in registers and the per-warp tables
# ---------------------------------------------------------------------------
FULL = 0xFFFFFFFF


def ballot(pred: np.ndarray) -> np.ndarray:
    """(..., 32) bool -> (...,) uint32 masks, lane i at bit i."""
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (pred.astype(np.uint64) * weights).sum(-1).astype(np.uint32)


def popc(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


def lane_flushes(keys: np.ndarray, block: int, vec: bool, per_flush=15):
    """The kernel's lane assignment, cut at its flushes: (n_blocks,
    flushes, keys a lane, 32) keys and their validity. With int4 loads
    round r gives lane l the keys 4 (64 r + l) + c and 4 (64 r + 32 + l) +
    c, c < 4, and each round is flushed; else step s gives it key 32 s + l
    and every ``per_flush`` steps are flushed."""
    n_blocks = keys.shape[0] // block
    kb = keys.reshape(n_blocks, block)
    lane = np.arange(32)
    if vec:
        rounds = -(-block // 256)
        four = 4 * (64 * np.arange(rounds)[:, None, None]
                    + np.array([0, 32])[None, :, None] + lane)
        idx = (four[:, :, None, :] + np.arange(4)[None, None, :, None])
        idx = idx.reshape(rounds, 8, 32)
        ok = (four < block)[:, :, None, :].repeat(4, 2).reshape(rounds, 8, 32)
    else:
        steps = -(-block // 32)
        flushes = -(-steps // per_flush)
        s = np.arange(flushes * per_flush).reshape(flushes, per_flush)
        idx = 32 * s[:, :, None] + lane
        ok = (idx < block) & (s < steps)[:, :, None]
    # a lane past the block's end loads 0, as the kernel's lanes do
    return (np.where(ok, kb[:, np.where(ok, idx, 0)], 0),
            np.broadcast_to(ok, (n_blocks,) + ok.shape))


def register_histograms(keys, n_bins, shift, block, vec, per_flush=15,
                        mask_invalid=True):
    """The register path's counts (n_bins <= 32): per lane and flush a
    word of 4-bit counters for each 8 bins, split into 16-bit fields,
    summed over the warp in uint32 and read by lane d for bin d."""
    slots, ok = lane_flushes(keys, block, vec, per_flush)
    if not mask_invalid:
        ok = np.ones_like(ok)
    d = ((slots.view(np.uint32) >> np.uint32(shift))
         & np.uint32(n_bins - 1)).astype(np.int64)
    out = np.zeros((slots.shape[0], n_bins), np.int64)
    for w in range(max(1, n_bins // 8)):
        one = np.where(ok & (d >> 3 == w), 1 << (4 * (d & 7)), 0)
        c = (one.sum(2) & FULL).astype(np.uint32)   # (blocks, flushes, 32)
        lo, hi = c & 0x0F0F0F0F, (c >> 4) & 0x0F0F0F0F
        fields = [lo & 0x00FF00FF, (lo >> 8) & 0x00FF00FF,
                  hi & 0x00FF00FF, (hi >> 8) & 0x00FF00FF]
        sums = [f.astype(np.int64).sum(-1) & FULL for f in fields]
        for j in range(min(8, n_bins)):      # lane 8 w + j reads bin 8 w + j
            s = sums[2 * (j & 1) + ((j >> 1) & 1)]
            out[:, 8 * w + j] = ((s >> (16 * (j >> 2))) & 0xFFFF).sum(-1)
    return out


def table_histograms(keys, n_bins, shift, block, vec):
    """The per-warp table path (n_bins >= 64): the peers of a digit
    (__match_any_sync over all lanes, invalid lanes holding -1), the
    lowest of them adding their count."""
    slots, ok = lane_flushes(keys, block, vec)
    digit = (slots.view(np.uint32) >> np.uint32(shift)) & np.uint32(
        n_bins - 1)
    dig = np.where(ok, digit.astype(np.int64), -1)
    peers = ballot(dig[..., :, None] == dig[..., None, :])
    lowest = popc((peers & (~peers + np.uint32(1))) - np.uint32(1))
    leader = ok & (lowest == np.arange(32))
    blk = np.broadcast_to(
        np.arange(dig.shape[0]).reshape((-1,) + (1,) * (dig.ndim - 1)),
        dig.shape)
    out = np.zeros((dig.shape[0], n_bins), np.int64)
    np.add.at(out, (blk[leader], dig[leader]), popc(peers)[leader])
    return out


def kernel_histograms(keys, n_bins, shift, block, vec):
    model = register_histograms if n_bins <= 32 else table_histograms
    return model(keys, n_bins, shift, block, vec)


@pytest.mark.parametrize("n_bins", [1 << k for k in range(9)])
@pytest.mark.parametrize("block", [1, 3, 100, 128, 256, 1000])
def test_histogram_model_equals_plain(n_bins, block):
    rng = np.random.RandomState(n_bins * 7 + block)
    keys = rng.randint(-(1 << 31), (1 << 31) - 1, block * 5,
                       dtype=np.int64).astype(np.int32)
    keys[::5] = -1                             # the routing padding key
    vecs = [False] + ([True] if block % 4 == 0 else [])
    for shift in (0, 1, 8, 16, 24, 31):
        want = block_histograms_ref(torch.from_numpy(keys), n_bins=n_bins,
                                    shift=shift, block=block).numpy()
        for vec in vecs:
            got = kernel_histograms(keys, n_bins, shift, block, vec)
            np.testing.assert_array_equal(got, want, err_msg=f"shift "
                                          f"{shift} vec {vec}")


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("n_bins", [1, 8, 32])
def test_histogram_model_holds_one_bin_full(vec, n_bins):
    """Every key in one bin: the fullest counters (15 a lane before a
    scalar flush, 8 with int4 loads) and fields (32 x 15)."""
    keys = np.full(32 * 15 * 4, n_bins - 1, np.int32)
    want = block_histograms_ref(torch.from_numpy(keys), n_bins=n_bins,
                                shift=0, block=keys.size).numpy()
    assert want[0, n_bins - 1] == keys.size
    np.testing.assert_array_equal(
        register_histograms(keys, n_bins, 0, keys.size, vec), want)


def test_histogram_model_has_teeth():
    """A scalar flush one key later overflows a 4-bit counter, and without
    the mask of valid lanes the lanes past a ragged block's end count."""
    keys = np.zeros(32 * 16, np.int32)
    want = block_histograms_ref(torch.from_numpy(keys), n_bins=8, shift=0,
                                block=keys.size).numpy()
    np.testing.assert_array_equal(
        register_histograms(keys, 8, 0, keys.size, False), want)
    late = register_histograms(keys, 8, 0, keys.size, False, per_flush=16)
    assert late[0, 0] == 0 and want[0, 0] == 32 * 16
    keys = 8 * np.arange(100, dtype=np.int32) + 1     # all in bin 1
    for vec in (False, True):
        np.testing.assert_array_equal(
            register_histograms(keys, 8, 0, 100, vec), [[0, 100] + [0] * 6])
        got = register_histograms(keys, 8, 0, 100, vec, mask_invalid=False)
        assert got[0, 0] > 0 and got[0, 1] == 100
