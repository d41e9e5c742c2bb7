"""The orders and layouts the CUDA kernels rely on, checked on the CPU.

A CUDA kernel cannot run here, so its arithmetic is held to its plain
version on a card (``tests/test_torch_cuda.py``). What can be checked here
is the design each kernel's exactness rests on:

* ``wkv6`` (``csrc/rwkv6_scan.cu``) sums over the key dim in its own
  order: a pairwise tree over each thread's G contiguous rows, then xor
  shuffles across the lanes that hold the neighbouring row groups, the
  first log2(C) levels transposed over the thread's C value columns. A
  torch model of that order must give ``pairwise_sum``'s bits, for every
  tile the kernel could take and for the ones it does take.
* ``join_probe`` (``csrc/join_probe.cu``) is a hash table per partition,
  built by linear probing from ``ops.hash_slot``. A numpy model of that
  table gives the plain version's bits on the edge cases, and the plain
  version gives the reference's answers on them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _join_cases import CASES, SF1_BK, case, colliding_keys
from repro.kernels.join_probe.ref import join_probe_ref as jax_join_ref
from repro_torch.analytics.hashing import partition_of
from repro_torch.kernels.join_probe.ops import (hash_slot, join_probe,
                                                table_log2)
from repro_torch.kernels.rwkv6_scan.ref import pairwise_sum, wkv6_ref


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def bitrev(x: int, C: int) -> int:
    r, b = 0, 1
    while b < C:
        r, x, b = (r << 1) | (x & 1), x >> 1, b << 1
    return r


def kernel_order_sum(p: torch.Tensor, G: int, C: int) -> torch.Tensor:
    """Sum over dim -2 of p (..., N, J) in the order of the wkv6 kernel:
    lane g of a column group holds rows [g G, (g + 1) G) and, in slot s,
    column s ^ bitrev(g mod C) of the group's C columns."""
    N, J = p.shape[-2:]
    NG = N // G
    x = list(p.unflatten(-2, (NG, G)).unbind(-2))     # G x (..., NG, J)
    s = 1
    while s < G:                                      # the in-thread tree
        for m in range(0, G, 2 * s):
            x[m] = x[m] + x[m + s]
        s *= 2
    part = x[0]
    acc = {g: [part[..., g, (s ^ bitrev(g % C, C))::C] for s in range(C)]
           for g in range(NG)}
    half, off = C // 2, 1
    while half >= 1:                                  # transposed levels
        acc = {g: [acc[g][s] + acc[g ^ off][s + half] for s in range(half)]
               for g in range(NG)}
        half, off = half // 2, off * 2
    off = C
    while off < NG:                                   # plain xor levels
        acc = {g: [acc[g][0] + acc[g ^ off][0]] for g in range(NG)}
        off *= 2
    y = torch.empty(p.shape[:-2] + (J,), dtype=p.dtype)
    for g in range(NG):                               # lanes g < C write
        col = bitrev(g % C, C)
        if g < C:
            y[..., col::C] = acc[g][0]
        else:                                         # every lane agrees
            assert np.array_equal(bits(acc[g][0]), bits(y[..., col::C]))
    return y


def products(seed: int, N: int, J: int = 16) -> torch.Tensor:
    """float32 terms over six decades of magnitude and both signs, so that
    a change of summation order shows in the bits."""
    rng = np.random.RandomState(seed)
    p = rng.randn(3, N, J) * 10.0 ** rng.uniform(-3, 3, (3, N, J))
    return torch.from_numpy(p.astype(np.float32))


TILES = [(N, G, C) for N in (16, 32, 64) for G in (2, 4, 8, 16)
         for C in (1, 2, 4) if G < N and N // G >= C]
KERNEL_TILES = [(16, 4, 2), (32, 4, 4), (64, 4, 4)]  # rwkv6_scan.cu


@pytest.mark.parametrize("N,G,C", TILES)
def test_kernel_sum_order_gives_pairwise_bits(N, G, C):
    p = products(N * G + C, N)
    got = kernel_order_sum(p, G, C)
    assert np.array_equal(bits(got), bits(pairwise_sum(p)))


def test_sum_order_check_has_teeth():
    """A sequential sum of the same terms differs from the tree's bits."""
    p = products(0, 64)
    seq = p[..., 0, :].clone()
    for i in range(1, 64):
        seq = seq + p[..., i, :]
    assert not np.array_equal(bits(seq), bits(pairwise_sum(p)))


def wkv6_kernel_order(r, k, v, w, u, G, C):
    """wkv6_ref's recurrence with the sum over i in the kernel's order."""
    B, S, H, N = r.shape
    state = torch.zeros((B, H, N, N))
    y = torch.empty((B, S, H, N))
    uf = u[..., :, None]
    for t in range(S):
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
        prod = r[:, t, ..., :, None] * (state + uf * kv)
        y[:, t] = kernel_order_sum(prod, G, C)
        state = w[:, t, ..., :, None] * state + kv
    return y, state


@pytest.mark.parametrize("N,G,C", KERNEL_TILES)
def test_wkv6_in_kernel_order_equals_plain_bits(N, G, C):
    rng = np.random.RandomState(N)
    B, S, H = 2, 9, 2
    r, k, v = (torch.from_numpy((rng.randn(B, S, H, N) * 0.5)
                                .astype(np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.6, 0.99, (B, S, H, N))
                         .astype(np.float32))
    u = torch.from_numpy((rng.randn(H, N) * 0.5).astype(np.float32))
    got = wkv6_kernel_order(r, k, v, w, u, G, C)
    want = wkv6_ref(r, k, v, w, u)
    for a, b in zip(got, want):
        assert np.array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# join_probe
# ---------------------------------------------------------------------------
def hashed_probe_model(bk, bv, pk):
    """The CUDA kernel's design in numpy: per partition a table of
    2^table_log2(Bk) entries filled by linear probing from hash_slot, the
    padding summed apart, a hit giving 0.0 + value."""
    P, Bk = bk.shape
    b = table_log2(Bk)
    mask = (1 << b) - 1
    vals = np.zeros(pk.shape, np.float32)
    found = np.zeros(pk.shape, bool)
    for p in range(P):
        table = np.full(1 << b, -1, np.int64)          # build slot, or -1
        start = hash_slot(torch.from_numpy(bk[p]), b).numpy()
        for slot in np.flatnonzero(bk[p] != -1):
            i = start[slot]
            while table[i] != -1:
                assert bk[p, table[i]] != bk[p, slot], "duplicate build key"
                i = (i + 1) & mask
            table[i] = slot
        pad = bk[p] == -1
        pad_sum = np.float32(0.0) + bv[p][pad].sum(dtype=np.float32)
        pstart = hash_slot(torch.from_numpy(pk[p]), b).numpy()
        for q, key in enumerate(pk[p]):
            if key == -1:
                vals[p, q], found[p, q] = pad_sum, pad.any()
                continue
            i = pstart[q]
            while table[i] != -1 and bk[p, table[i]] != key:
                i = (i + 1) & mask
            if table[i] != -1:
                vals[p, q] = np.float32(0.0) + bv[p, table[i]]
                found[p, q] = True
    return vals, found


SMALL = {"sf1 partition": dict(pk=300)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_hashed_probe_model_equals_plain_bits(name):
    bk, bv, pk = case(name, **SMALL.get(name, {}))
    want_v, want_f = join_probe(*(torch.from_numpy(x) for x in (bk, bv, pk)))
    got_v, got_f = hashed_probe_model(bk, bv, pk)
    assert np.array_equal(got_v.view(np.int32), bits(want_v))
    assert np.array_equal(got_f, want_f.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_join_probe_matches_reference(name):
    bk, bv, pk = case(name, **SMALL.get(name, {}))
    got_v, got_f = join_probe(*(torch.from_numpy(x) for x in (bk, bv, pk)))
    want_v, want_f = jax_join_ref(jnp.asarray(bk), jnp.asarray(bv),
                                  jnp.asarray(pk))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    # integer-valued payloads: the sums are exact in any order
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_join_cases_are_what_they_say():
    bk, _, pk = case("keys in one hash chain")
    b = table_log2(bk.shape[1])
    starts = hash_slot(torch.from_numpy(pk[pk != -1]), b)
    assert starts.unique().numel() == 1
    assert colliding_keys(5000, 100).size == 5000
    bk, bv, pk = case("sf1 partition")
    assert bk.shape == (1, SF1_BK) and (pk == -1).any()
    bk, _, _ = case("all-padding partition")
    assert (bk[1] == -1).all() and not (bk[2] == -1).any()
    for name in CASES:
        bk = case(name, **SMALL.get(name, {}))[0]
        for row in bk:
            real = row[row != -1]
            assert np.unique(real).size == real.size


def test_hash_slot_is_murmur3_finalizer_top_bits():
    def fmix32(h):
        h ^= h >> 16
        h = h * 0x85EBCA6B & 0xFFFFFFFF
        h ^= h >> 13
        h = h * 0xC2B2AE35 & 0xFFFFFFFF
        return h ^ h >> 16

    keys = torch.tensor([-(1 << 31), -2, -1, 0, 1, (1 << 31) - 1],
                        dtype=torch.int32)
    got = hash_slot(keys, 17).tolist()
    want = [fmix32(k & 0xFFFFFFFF) >> 15 for k in keys.tolist()]
    assert got == want and all(0 <= s < 1 << 17 for s in got)
    assert table_log2(46_976) == 17 and table_log2(0) == 6
    assert all((1 << table_log2(n)) >= 2 * n for n in (1, 63, 64, 65, 4097))


def test_hash_spreads_the_keys_of_one_partition():
    """The partitions are cut by the top bits of a multiply-shift hash
    (hashing.partition_of); the table's hash must not share them, or one
    partition's keys would crowd into 1/P of its table. With the load at
    most 1/2, linear probing's walks stay short."""
    P, Bk = 64, 2000
    keys = torch.arange(0, 4 * P * Bk, dtype=torch.int32)
    mine = keys[partition_of(keys, P) == 3][:Bk]
    assert mine.numel() == Bk
    b = table_log2(Bk)
    starts = hash_slot(mine, b).numpy()
    table = np.zeros(1 << b, bool)
    walks = []
    for s0 in starts:
        i = s0
        while table[i]:
            i = (i + 1) & ((1 << b) - 1)
        table[i] = True
        walks.append(((i - s0) & ((1 << b) - 1)) + 1)
    assert np.mean(walks) < 2.0 and max(walks) < 40
    assert np.unique(starts).size > (1 << b) // 4
