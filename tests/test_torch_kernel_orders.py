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
* ``radix_probe`` (``csrc/radix_probe.cu``) stages the top levels of every
  bucket's search in shared memory and runs a lower bound over (lo, len)
  that keeps whether the run's upper end holds the key, so a hit needs no
  last read of the keys. A torch model of
  that search gives the plain version's bits on the edge cases of
  ``tests/_radix_cases.py``, and the plain version gives the reference's.
* ``hash_aggregate_multi`` (``csrc/hash_aggregate.cu``) adds its rows in an
  order fixed by the data and its launch plan: trees over the peers of
  32-row groups, group sums in group order, chunks in chunk order. The
  torch model of that order (``tests/_agg_order.py``, whose bits the kernel
  gives on a card) holds float64 sums within 1e-5 on q18-like inputs, and
  its bits depend on a partition's own rows alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _agg_order import kernel_order_sums, q18_like
from _join_cases import CASES, SF1_BK, case, colliding_keys
from _radix_cases import CASES as RADIX_CASES
from _radix_cases import BITS, bucket_of
from _radix_cases import case as radix_case
from repro.analytics import join as jax_join
from repro.kernels.join_probe.ref import join_probe_ref as jax_join_ref
from repro_torch.analytics import join as torch_join
from repro_torch.analytics.hashing import multiply_shift, partition_of
from repro_torch.kernels.hash_aggregate.ops import launch_plan
from repro_torch.kernels.join_probe.ops import (hash_slot, join_probe,
                                                table_log2)
from repro_torch.kernels.radix_probe import radix_probe
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


# ---------------------------------------------------------------------------
# radix_probe
# ---------------------------------------------------------------------------
def _lower_bound_step(k, q, lo, ln, eq, live):
    """The kernel's step on the live lanes: right past k < q, else the
    left half, whose upper end is k (eq: whether it is q)."""
    half = ln >> 1
    right = live & (k < q)
    left = live & ~(k < q)
    return (torch.where(right, lo + half + 1, lo),
            torch.where(right, ln - half - 1, torch.where(left, half, ln)),
            torch.where(left, k == q, eq))


def staged_search_model(index, pk, levels):
    """The CUDA kernel's design in torch: the keys of the first ``levels``
    depths of every bucket's search staged by replaying each node's path
    (0 where its range is empty), the search reading them there, then the
    rest from the sorted keys, and a hit's value read at the end."""
    sk, sv, starts = index.sorted_keys, index.sorted_vals, index.bucket_starts
    nodes = (1 << levels) - 1
    tree = torch.zeros((starts.numel() - 1, max(nodes, 1)), dtype=sk.dtype)
    for node in range(1, nodes + 1):
        lo, ln = starts[:-1].clone(), starts[1:] - starts[:-1]
        for d in range(node.bit_length() - 2, -1, -1):
            half = ln >> 1
            if (node >> d) & 1:
                lo, ln = lo + half + 1, ln - half - 1
            else:
                ln = half
        at = torch.clamp(lo + (ln >> 1), 0, max(sk.numel() - 1, 0))
        tree[:, node - 1] = torch.where(ln > 0, sk[at], 0)
    b = multiply_shift(pk, index.bits)
    lo, ln = starts[b], starts[b + 1] - starts[b]
    eq = torch.zeros(pk.shape, dtype=torch.bool)
    node = torch.ones_like(lo)
    for _ in range(levels):
        live = ln > 0
        k = tree[b, torch.clamp(node - 1, max=nodes - 1)]
        node = torch.where(live, 2 * node + (k < pk).long(), node)
        lo, ln, eq = _lower_bound_step(k, pk, lo, ln, eq, live)
    last = max(sk.numel() - 1, 0)
    while bool((ln > 0).any()):
        live = ln > 0
        k = sk[torch.clamp(lo + (ln >> 1), 0, last)]
        lo, ln, eq = _lower_bound_step(k, pk, lo, ln, eq, live)
    at = torch.clamp(lo, 0, last)
    return torch.where(eq, sv[at], 0.0), eq


def _radix_inputs(name, n_bits=BITS):
    bk, bv, pk = (torch.from_numpy(x) for x in radix_case(name))
    return torch_join.build_radix_index(bk, bv, bits=n_bits), pk


# (staged levels, bits): the kernel's 5 at 1,024 buckets, where a Blanas
# draw of 2,000 keys leaves runs of a few keys, and at 16 buckets and one,
# whose runs reach past the staged levels; fewer levels, as at more buckets
@pytest.mark.parametrize("levels,n_bits", [
    (5, BITS), (0, BITS), (5, 4), (2, 4), (0, 0)])
@pytest.mark.parametrize("name", sorted(RADIX_CASES))
def test_staged_search_model_equals_plain_bits(name, levels, n_bits):
    index, pk = _radix_inputs(name, n_bits)
    want_v, want_f = radix_probe(index.sorted_keys, index.sorted_vals,
                                 index.bucket_starts, index.bits, pk)
    got_v, got_f = staged_search_model(index, pk, levels)
    assert np.array_equal(bits(got_v), bits(want_v))
    assert torch.equal(got_f, want_f)


@pytest.mark.parametrize("name", sorted(RADIX_CASES))
def test_plain_radix_probe_matches_reference(name):
    """The wrapper on CPU tensors (the plain version) against the JAX
    reference's probe_radix_index, vals as bits and found."""
    bk, bv, pk = radix_case(name)
    index, tpk = _radix_inputs(name)
    got_v, got_f = radix_probe(index.sorted_keys, index.sorted_vals,
                               index.bucket_starts, index.bits, tpk)
    want_v, want_f = jax_join.probe_radix_index(
        jax_join.build_radix_index(jnp.asarray(bk), jnp.asarray(bv)),
        jnp.asarray(pk))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(bits(got_v),
                                  np.asarray(want_v).view(np.int32))


def test_radix_probe_cuda_mode_on_a_cpu_tensor_raises():
    index, pk = _radix_inputs("blanas")
    with pytest.raises(ValueError, match="CUDA device"):
        radix_probe(index.sorted_keys, index.sorted_vals,
                    index.bucket_starts, index.bits, pk, mode="cuda")


def test_radix_cases_are_what_they_say():
    index, pk = _radix_inputs("past the run")
    starts = index.bucket_starts.numpy()
    sk = index.sorted_keys.numpy()
    for bucket in (500, (1 << BITS) - 1):
        run = sk[starts[bucket]:starts[bucket + 1]]
        mine = pk.numpy()[bucket_of(pk.numpy()) == bucket]
        assert run.size == 50 and (mine > run.max()).sum() >= 10
    assert starts[-1] == starts[(1 << BITS) - 1] + 50
    index, pk = _radix_inputs("empty buckets")
    assert (np.diff(index.bucket_starts.numpy()) == 0).sum() > 700
    bk, _, pk = radix_case("keys -1, -2 and +-2^31")
    assert {-1, -(1 << 31)} <= set(bk.tolist())
    assert not {-2, (1 << 31) - 1} & set(bk.tolist())
    assert {-1, -2, -(1 << 31), (1 << 31) - 1} <= set(pk.tolist())
    bk, bv, _ = radix_case("duplicate build keys")
    assert np.unique(bk).size < bk.size and (np.signbit(bv) & (bv == 0)).any()
    assert bucket_of(np.array([-1], np.int32))[0] == int(
        multiply_shift(torch.tensor([-1], dtype=torch.int32), BITS)[0])


Q18_PLAN = launch_plan(64, 187_648, 2, 23_552, n_sms=132)   # q18 at SF1


def agg_inputs(kind):
    """(ids (P, T), vals (P, T, C), n_bins, plan) as torch tensors."""
    if kind == "q18-like":                  # two partitions of q18's call
        parts = [q18_like(seed) for seed in (0, 1)]
        ids, vals = (np.stack(x) for x in zip(*parts))
        return torch.from_numpy(ids), torch.from_numpy(vals), 23_552, \
            Q18_PLAN
    rng = np.random.RandomState(3)
    if kind == "all-one-bin":               # one bin takes every row
        ids, vals = q18_like(2)
        vals = np.abs(vals) + 1.0
        return torch.full((1, ids.shape[0]), 7, dtype=torch.int32), \
            torch.from_numpy(vals[None]), 23_552, Q18_PLAN
    # "q1-like": private tables, 6 groups, 2% masked rows, C = 5
    ids = rng.randint(0, 6, (2, 100_000)).astype(np.int32)
    qty = rng.randint(1, 51, (2, 100_000)).astype(np.float32)
    price = qty * rng.uniform(900, 2100, qty.shape).astype(np.float32)
    vals = np.stack([qty, price, price * 0.95, price * 0.97,
                     np.ones_like(qty)], axis=2).astype(np.float32)
    vals[rng.rand(2, 100_000) < 0.02] = 0.0
    ids, vals = torch.from_numpy(ids), torch.from_numpy(vals)
    return ids, vals, 128, launch_plan(2, 100_000, 5, 128, n_sms=132)


def f64_sums(ids, vals, n_bins):
    P, T, C = vals.shape
    out = torch.zeros((P, n_bins, C), dtype=torch.float64)
    for p in range(P):
        ok = (ids[p] >= 0) & (ids[p] < n_bins)
        out[p].index_add_(0, ids[p][ok].long(), vals[p][ok].double())
    return out


@pytest.mark.parametrize("kind", ["q18-like", "all-one-bin", "q1-like"])
def test_aggregate_order_holds_float64(kind):
    ids, vals, n_bins, plan = agg_inputs(kind)
    got = kernel_order_sums(ids, vals, n_bins, plan=plan)
    want = f64_sums(ids, vals, n_bins)
    scale = f64_sums(ids, vals.abs(), n_bins)
    assert kind == "q1-like" or not plan[3]          # q18's wide table
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale).all()), float((err / scale).max())


@pytest.mark.parametrize("kind", ["q18-like", "q1-like"])
def test_aggregate_order_depends_on_the_data_alone(kind):
    ids, vals, n_bins, plan = agg_inputs(kind)
    got = kernel_order_sums(ids, vals, n_bins, plan=plan)
    # a partition's sums are its own rows' alone: swapping partitions
    # swaps the results bit for bit
    swap = kernel_order_sums(ids.flip(0), vals.flip(0), n_bins, plan=plan)
    assert np.array_equal(bits(swap), bits(got.flip(0)))
    # renaming the bins renames the sums: the order does not follow bin
    # labels (the kernel's in-order runs and its general path agree)
    perm = torch.from_numpy(np.random.RandomState(5).permutation(n_bins))
    renamed = kernel_order_sums(perm[ids.long()].to(torch.int32), vals,
                                n_bins, plan=plan)
    assert np.array_equal(bits(renamed[:, perm]), bits(got))
    # a row whose values are all +-0 is a row that is not there
    zero = torch.zeros(ids.shape, dtype=torch.bool)
    zero[:, 5::97] = True
    v0 = vals.clone()
    v0[zero] = 0.0
    v0[:, 5::194] = -0.0
    moved = torch.where(zero, n_bins + 3, ids)
    a = kernel_order_sums(ids, v0, n_bins, plan=plan)
    b = kernel_order_sums(moved, v0, n_bins, plan=plan)
    assert np.array_equal(bits(a), bits(b))
    assert not bool(torch.signbit(a[a == 0]).any())


def test_aggregate_order_check_has_teeth():
    """The rows' order within a group shows in the bits: the model is not
    an order-free sum."""
    ids, vals, n_bins, plan = agg_inputs("all-one-bin")
    got = kernel_order_sums(ids, vals, n_bins, plan=plan)
    rev = kernel_order_sums(ids, vals.flip(1), n_bins, plan=plan)
    assert not np.array_equal(bits(got), bits(rev))
