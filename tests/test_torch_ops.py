"""W1-W4 on one device: the port's ``analytics/aggregate.py`` and
``analytics/join.py`` against the reference's on the same numpy inputs,
at the shapes of ``tests/test_analytics_ops.py``.

Tolerances: counts, found flags, overflow and medians equal the
reference's; W3 and W4 checksums within rtol 1e-5 of the reference's;
each index kind's build (tables, sorted arrays, bucket directory) equal
to the reference's, float payloads bit for bit. The reference runs on the
CPU as its own tests run it (the join kernel through its plain version,
``mode="ref"``); so does the port here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.analytics import aggregate as RA
from repro.analytics import datasets as RD
from repro.analytics import join as RJ
from repro_torch.analytics import aggregate as TA
from repro_torch.analytics import columnar
from repro_torch.analytics import datasets as TD
from repro_torch.analytics import join as TJ

CHECKSUM_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("gen", sorted(RD.AGG_DATASETS))
def test_count_matches_reference(gen):
    ds = RD.AGG_DATASETS[gen](8192, 256, seed=3)
    assert np.array_equal(TD.AGG_DATASETS[gen](8192, 256, seed=3).keys,
                          ds.keys)
    want = np.asarray(RA.count_direct(jnp.asarray(ds.keys), 256))
    got = TA.count_direct(_t(ds.keys), 256)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for P, cf in ((8, 4.0), (8, 0.5)):       # fits, and overflows
        want_p, want_o = RA.count_partitioned(
            jnp.asarray(ds.keys), 256, n_partitions=P, capacity_factor=cf,
            mode="ref")
        got_p, got_o = TA.count_partitioned(
            _t(ds.keys), 256, n_partitions=P, capacity_factor=cf)
        assert int(got_o) == int(want_o), (gen, cf)
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert int(got_o) > 0 or gen == "sequential"


@pytest.mark.parametrize("gen", ["moving_cluster", "zipf", "heavy_hitter"])
def test_median_matches_reference(gen):
    ds = RD.AGG_DATASETS[gen](4096, 128, seed=4)
    want = np.asarray(RA.median_direct(jnp.asarray(ds.keys),
                                       jnp.asarray(ds.vals), 128))
    got = TA.median_jit(_t(ds.keys), _t(ds.vals), 128)
    assert TA.median_jit is TA.median_direct
    np.testing.assert_array_equal(got.numpy(), want)   # NaN == NaN here


def test_median_starts_are_int64_counts():
    """The run starts behind every median: the int64 cumsum of the
    counts, as numpy computes it, with the rows past the excluded key -1
    shifting every start (the reference's f32 cumsum is exact only below
    2^24 rows; these are exact at any size)."""
    rng = np.random.RandomState(9)
    keys = rng.randint(-1, 50, 3000).astype(np.int32)
    keys[:7] = 49                              # the last group, heavy
    vals = rng.rand(3000).astype(np.float32)
    _sv, counts, starts, _sk = columnar._segment_selection(
        _t(keys), _t(vals), 50)
    want_c = np.bincount(keys[keys >= 0], minlength=50)
    want_s = (np.cumsum(want_c) - want_c + int((keys < 0).sum()))
    assert starts.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy(), want_c.astype(np.float32))
    np.testing.assert_array_equal(starts.numpy(), want_s)


def _lookup_sum(jd):
    lookup = dict(zip(jd.build_keys.tolist(), jd.build_vals.tolist()))
    return float(sum(lookup[k] for k in jd.probe_keys.tolist()))


@pytest.mark.parametrize("P,cf", [(8, 2.0), (8, 0.5), (64, 2.0)])
def test_hash_join_matches_reference(P, cf):
    jd = RD.blanas_join(1024, 16384, seed=5)
    want = RJ.hash_join(jnp.asarray(jd.build_keys), jnp.asarray(jd.build_vals),
                        jnp.asarray(jd.probe_keys), n_partitions=P,
                        capacity_factor=cf, mode="ref")
    got = TJ.hash_join(_t(jd.build_keys), _t(jd.build_vals),
                       _t(jd.probe_keys), n_partitions=P, capacity_factor=cf)
    assert int(got[0]) == int(want[0]) and int(got[2]) == int(want[2])
    np.testing.assert_allclose(float(got[1]), float(want[1]),
                               rtol=CHECKSUM_RTOL)
    if cf >= 2.0:
        assert int(got[2]) == 0 and int(got[0]) == len(jd.probe_keys)
        assert abs(float(got[1]) - _lookup_sum(jd)) / _lookup_sum(jd) < 1e-4
    else:
        assert int(got[2]) > 0                   # counted, never hidden


def test_hash_join_with_misses_matches_reference():
    bk = np.arange(0, 512, 2).astype(np.int32)           # even keys only
    bv = np.ones(256, np.float32)
    pk = np.arange(512).astype(np.int32)                 # half miss
    want = RJ.hash_join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                        n_partitions=4, capacity_factor=4.0, mode="ref")
    got = TJ.hash_join(_t(bk), _t(bv), _t(pk), n_partitions=4,
                       capacity_factor=4.0)
    assert int(got[0]) == int(want[0]) == 256
    assert float(got[1]) == float(want[1]) == 256.0
    assert int(got[2]) == int(want[2]) == 0


def _builds(kind, bk, bv):
    if kind == "radix":
        r, t = (RJ.build_radix_index(jnp.asarray(bk), jnp.asarray(bv)),
                TJ.build_radix_index(_t(bk), _t(bv)))
        return ([r.sorted_keys, r.bucket_starts], [r.sorted_vals],
                [t.sorted_keys, t.bucket_starts], [t.sorted_vals])
    if kind == "sorted":
        r, t = (RJ.build_sorted_index(jnp.asarray(bk), jnp.asarray(bv)),
                TJ.build_sorted_index(_t(bk), _t(bv)))
        return [r.sorted_keys], [r.sorted_vals], [t.sorted_keys], \
            [t.sorted_vals]
    r, t = (RJ.build_hash_index(jnp.asarray(bk), jnp.asarray(bv)),
            TJ.build_hash_index(_t(bk), _t(bv)))
    assert r.capacity == t.capacity and r.max_probes == t.max_probes
    return [r.table_keys], [r.table_vals], [t.table_keys], [t.table_vals]


@pytest.mark.parametrize("kind", ["radix", "sorted", "hash"])
def test_index_builds_equal_reference(kind):
    jd = RD.blanas_join(512, 4096, seed=6)
    r_int, r_f, t_int, t_f = _builds(kind, jd.build_keys, jd.build_vals)
    for a, b in zip(r_int, t_int):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(r_f, t_f):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


def test_hash_index_contention_equals_reference():
    """Keys crowded into a few home slots: the scatter-max arbitration
    (the highest key wins a contested slot) and the keys left unplaced
    after ``max_probes`` rounds are the reference's."""
    rng = np.random.RandomState(2)
    cap = 1 << 10
    keys = (rng.permutation(4000)[:480] * cap).astype(np.int32)
    keys[::3] += 1                       # two home-slot families
    vals = rng.rand(480).astype(np.float32)
    r_int, r_f, t_int, t_f = _builds("hash", keys, vals)
    np.testing.assert_array_equal(t_int[0].numpy(), np.asarray(r_int[0]))
    np.testing.assert_array_equal(_bits(t_f[0].numpy()), _bits(r_f[0]))
    assert (t_int[0].numpy() >= 0).sum() < len(keys)    # some left out


@pytest.mark.parametrize("kind", ["radix", "sorted", "hash"])
@pytest.mark.parametrize("misses", [False, True])
def test_index_join_matches_reference(kind, misses):
    jd = RD.blanas_join(512, 4096, seed=6)
    pk = jd.probe_keys.copy()
    if misses:
        pk[::5] = np.int32(4 * 512 + 7)          # no build key is this
        pk[1::7] = -1
    want = RJ.index_join(jnp.asarray(jd.build_keys),
                         jnp.asarray(jd.build_vals), jnp.asarray(pk), kind)
    got = TJ.index_join(_t(jd.build_keys), _t(jd.build_vals), _t(pk), kind)
    assert int(got[0]) == int(want[0])
    np.testing.assert_allclose(float(got[1]), float(want[1]),
                               rtol=CHECKSUM_RTOL)
    if not misses:
        assert int(got[0]) == len(pk)
        assert abs(float(got[1]) - _lookup_sum(jd)) / _lookup_sum(jd) < 1e-4
    # the probe's per-key results, not only their sums
    probe = {"radix": (RJ.probe_radix_index, TJ.probe_radix_index,
                       RJ.build_radix_index, TJ.build_radix_index),
             "sorted": (RJ.probe_sorted_index, TJ.probe_sorted_index,
                        RJ.build_sorted_index, TJ.build_sorted_index),
             "hash": (RJ.probe_hash_index, TJ.probe_hash_index,
                      RJ.build_hash_index, TJ.build_hash_index)}[kind]
    rv, rf = probe[0](probe[2](jnp.asarray(jd.build_keys),
                               jnp.asarray(jd.build_vals)), jnp.asarray(pk))
    tv, tf = probe[1](probe[3](_t(jd.build_keys), _t(jd.build_vals)), _t(pk))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(rv))


def test_index_join_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown index kind"):
        TJ.index_join(_t(np.arange(4, dtype=np.int32)),
                      _t(np.ones(4, np.float32)),
                      _t(np.arange(4, dtype=np.int32)), "btree")
