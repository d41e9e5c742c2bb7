"""The port's hashing and columnar operators against the JAX reference,
on the same numpy inputs (the port on the CPU)."""
import numpy as np
import jax.numpy as jnp
import jax
import pytest
import torch

from repro.analytics import columnar as RC
from repro.analytics import hashing as RH
from repro_torch.analytics import columnar as TC
from repro_torch.analytics import hashing as TH
from repro_torch.analytics import planner as TP


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_partitions", [1, 2, 6, 32, 64, 1000])
def test_partition_of_matches_reference(n_partitions):
    rng = np.random.RandomState(n_partitions)
    keys = rng.randint(-(1 << 31), (1 << 31) - 1, 5000).astype(np.int32)
    keys[:6] = [-1, 0, 1, -(1 << 31), (1 << 31) - 1, -2]
    want = np.asarray(RH.partition_of(jnp.asarray(keys), n_partitions))
    got = TH.partition_of(torch.from_numpy(keys), n_partitions)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [32, 20, 7])
def test_multiply_shift_matches_uint32_reference(bits):
    rng = np.random.RandomState(bits)
    keys = rng.randint(-(1 << 31), (1 << 31) - 1, 4000).astype(np.int32)
    want = np.asarray(RH.multiply_shift(jnp.asarray(keys), bits))
    got = TH.multiply_shift(torch.from_numpy(keys), bits)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("vals_dims", [1, 2])
def test_pad_partitions_matches_reference(vals_dims):
    rng = np.random.RandomState(vals_dims)
    P, pad_t = 8, 40
    keys = rng.randint(-50, 1000, 300).astype(np.int32)
    part = np.asarray(RH.partition_of(jnp.asarray(keys), P))
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=P)
    starts = np.cumsum(counts) - counts
    shape = (300,) if vals_dims == 1 else (300, 3)
    vals = rng.randn(*shape).astype(np.float32)
    want = RH.pad_partitions(jnp.asarray(keys[order]),
                             jnp.asarray(vals[order]), jnp.asarray(starts),
                             jnp.asarray(counts), P, pad_t)
    got = TH.pad_partitions(torch.from_numpy(keys[order]),
                            torch.from_numpy(vals[order]),
                            torch.from_numpy(starts), torch.from_numpy(counts),
                            P, pad_t)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert int(got[2]) > 0                   # some partition overflowed


def _tables(rng, n, n_groups):
    k = rng.randint(0, n_groups, n).astype(np.int32)
    v = (rng.randn(n) * 100).astype(np.float32)
    u = rng.rand(n).astype(np.float32)
    keep = rng.rand(n) < 0.7
    ref = RC.Table({"k": jnp.asarray(k), "v": jnp.asarray(v),
                    "u": jnp.asarray(u)}).filter(jnp.asarray(keep))
    got = TC.Table({"k": torch.from_numpy(k), "v": torch.from_numpy(v),
                    "u": torch.from_numpy(u)}).filter(torch.from_numpy(keep))
    return ref, got


AGGS = {"s": ("sum", "v"), "a": ("avg", "v"), "c": ("count", "v"),
        "s2": ("sum", "u"), "mx": ("max", "v"), "mn": ("min", "v"),
        "md": ("median", "v"), "q": ("quantile:0.3", "u"),
        "d": ("distinct", "k")}


@pytest.mark.parametrize("executor,layout", [("xla", None),
                                             ("kernel", "dense"),
                                             ("kernel", "partitioned"),
                                             ("kernel", None)])
@pytest.mark.parametrize("n_groups", [37, 6000])
def test_group_aggregate_matches_reference_all_ops(executor, layout,
                                                   n_groups):
    """The port of test_group_aggregate_kernel_matches_xla_all_ops, held
    against the reference: every op, masked rows, every layout."""
    rng = np.random.RandomState(n_groups)
    ref_t, got_t = _tables(rng, 10_000, n_groups)
    want = RC.group_aggregate(ref_t, "k", n_groups, AGGS, executor=executor,
                              layout=layout)
    got = TC.group_aggregate(got_t, "k", n_groups, AGGS, executor=executor,
                             layout=layout)
    assert set(got) == set(want)
    assert int(got["_overflow"]) == int(np.asarray(want["_overflow"])) == 0
    for k in ("c", "_count", "mx", "mn", "md", "d"):       # exact
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_np(got["q"]), np.asarray(want["q"]),
                               rtol=1e-6)
    for k in ("s", "a", "s2"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-4, err_msg=k)


def test_partitioned_overflow_count_matches_reference():
    n, n_groups = 20_000, 6000
    keys = np.zeros(n, np.int32)                  # every row in partition 0
    vals = np.ones(n, np.float32)
    want = RC.group_aggregate(
        RC.Table({"k": jnp.asarray(keys), "v": jnp.asarray(vals)}), "k",
        n_groups, {"s": ("sum", "v")}, executor="kernel", capacity_factor=1.0)
    got = TC.group_aggregate(
        TC.Table({"k": torch.from_numpy(keys), "v": torch.from_numpy(vals)}),
        "k", n_groups, {"s": ("sum", "v")}, executor="kernel",
        capacity_factor=1.0)
    assert int(got["_overflow"]) == int(np.asarray(want["_overflow"])) > 0
    np.testing.assert_array_equal(_np(got["s"]), np.asarray(want["s"]))


def _join_sides(rng, n_dim, n_fact, skew):
    dk = rng.permutation(n_dim).astype(np.int32)
    payload = rng.randn(n_dim).astype(np.float32)
    dkeep = rng.rand(n_dim) < 0.8
    if skew:
        fk = np.concatenate([rng.randint(0, 32, n_fact // 2),
                             rng.randint(0, n_dim + 64, n_fact - n_fact // 2)])
    else:
        fk = rng.randint(0, n_dim + 100, n_fact)
    fk = fk.astype(np.int32)
    fkeep = rng.rand(n_fact) < 0.9
    ref = (RC.Table({"dk": jnp.asarray(dk), "p": jnp.asarray(payload)})
           .filter(jnp.asarray(dkeep)),
           RC.Table({"fk": jnp.asarray(fk)}).filter(jnp.asarray(fkeep)))
    got = (TC.Table({"dk": torch.from_numpy(dk),
                     "p": torch.from_numpy(payload)})
           .filter(torch.from_numpy(dkeep)),
           TC.Table({"fk": torch.from_numpy(fk)})
           .filter(torch.from_numpy(fkeep)))
    return ref, got


def _assert_joined_equal(got, want):
    np.testing.assert_array_equal(_np(got.weights()),
                                  np.asarray(want.weights()))
    np.testing.assert_array_equal(_np(got.col("p")) * _np(got.weights()),
                                  np.asarray(want.col("p"))
                                  * np.asarray(want.weights()))


def test_pkfk_join_matches_reference():
    (rd, rf), (gd, gf) = _join_sides(np.random.RandomState(1), 500, 4000,
                                     skew=False)
    _assert_joined_equal(TC.pkfk_join(gf, gd, "fk", "dk", {"p": "p"}),
                         RC.pkfk_join(rf, rd, "fk", "dk", {"p": "p"}))
    assert "dk" in gd.index_cache            # build index was cached


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("skew,n_partitions,cf", [(False, 32, 4.0),
                                                  (True, 2, 0.25)])
def test_pkfk_join_kernel_matches_reference(residual, skew, n_partitions,
                                            cf):
    (rd, rf), (gd, gf) = _join_sides(np.random.RandomState(2), 2048, 4096,
                                     skew)
    kw = dict(n_partitions=n_partitions, capacity_factor=cf,
              residual=residual)
    want, wovf = RC.pkfk_join_kernel(rf, rd, "fk", "dk", {"p": "p"},
                                     mode="ref", **kw)
    got, govf = TC.pkfk_join_kernel(gf, gd, "fk", "dk", {"p": "p"}, **kw)
    assert int(govf) == int(np.asarray(wovf))
    assert (int(govf) > 0) == (skew and not residual)
    _assert_joined_equal(got, want)


def test_pkfk_join_kernel_refuses_2_pow_24_rows():
    big = TC.Table({"k": torch.zeros(1 << 24, dtype=torch.int32)})
    small = TC.Table({"k": torch.arange(10, dtype=torch.int32)})
    with pytest.raises(ValueError, match="2\\^24"):
        TC.pkfk_join_kernel(big, small, "k", "k", {})


@pytest.mark.parametrize("fn", ["segment_median", "segment_distinct"])
def test_segment_selection_matches_reference_with_excluded_keys(fn):
    rng = np.random.RandomState(3)
    keys = rng.randint(-1, 12, 2000).astype(np.int32)      # -1 is excluded
    keys[:5] = 40                                          # clip to last
    vals = rng.randint(0, 30, 2000).astype(np.float32)     # many ties
    want = getattr(RC, fn)(jnp.asarray(keys), jnp.asarray(vals), 10)
    got = getattr(TC, fn)(torch.from_numpy(keys), torch.from_numpy(vals), 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("rank", [0.1, 0.25, 0.5, 0.9])
def test_segment_quantile_matches_reference(rank):
    rng = np.random.RandomState(4)
    keys = rng.randint(-1, 7, 999).astype(np.int32)
    vals = (rng.rand(999) * 1e4).astype(np.float32)
    want = RC.segment_quantile(jnp.asarray(keys), jnp.asarray(vals), 8, rank)
    got = TC.segment_quantile(torch.from_numpy(keys), torch.from_numpy(vals),
                              8, rank)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_segment_sum_drops_out_of_range_ids_like_jax():
    ids = np.array([0, 3, -1, 5, 2, 3, 9], np.int32)
    data = np.arange(7, dtype=np.float32)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=4)
    got = TC.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(5000,), (5000, 3), (5000, 2, 2), (0, 3)])
def test_segment_sum_matches_jax_on_stacked_columns(shape):
    """The sort + per-segment reduction route (the same bits on every run,
    no float atomics) against jax.ops.segment_sum, trailing dims and an
    empty input included; f32 sums in another order."""
    rng = np.random.RandomState(len(shape))
    ids = rng.randint(-3, 70, shape[0]).astype(np.int64)
    data = (rng.randn(*shape) * 1e3).astype(np.float32)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=64)
    got = TC.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 64)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-2)


@pytest.mark.parametrize("dtype,width,offset", [
    (torch.float32, 1, 0), (torch.float32, 3, 0), (torch.float32, 4, 0),
    (torch.float32, 8, 0), (torch.float32, 12, 0), (torch.int64, 2, 0),
    (torch.float64, 6, 0), (torch.float32, 4, 1), (torch.float32, 4, 4)])
def test_take_rows_is_row_indexing_bit_for_bit(dtype, width, offset):
    """16-byte rows go through the flat view, others through indexing;
    a view whose start is not 16-byte aligned falls back to indexing.
    Every bit is kept (NaN payloads and -0.0 included)."""
    rng = np.random.RandomState(width + offset)
    n = 1000
    flat = torch.from_numpy(rng.randint(-(1 << 31), (1 << 31) - 1,
                                        (n + 1) * width * 2,
                                        dtype=np.int64).astype(np.int32))
    x = flat.view(torch.float32) if dtype == torch.float32 else \
        flat.view(dtype)
    x = x[offset:offset + n * width].reshape(n, width)
    idx = torch.from_numpy(rng.randint(0, n, 777))
    got = TC.take_rows(x, idx)
    want = x[idx]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert TC.take_rows(x, idx[:0]).shape == (0, width)


def test_top_k_breaks_ties_by_lowest_index_like_lax():
    x = np.array([3, 7, 7, 1, 7, 3, 9, 3, 0, 7], np.float32)
    for k in (1, 3, 5, 8, 10):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = TP.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert gi.dtype == torch.int32
    # a large all-tie vector: the first k indices, in order
    _, gi = TP.top_k(torch.zeros(10_000), 10)
    np.testing.assert_array_equal(gi.numpy(), np.arange(10))


def test_index_cache_propagation():
    t = TC.Table({"a": torch.randperm(256).int(), "b": torch.randn(256)})
    t.key_index("a")
    assert "a" in t.filter(t.col("b") > 0).index_cache
    assert "a" in t.with_columns(c=t.col("b")).index_cache
    assert "a" not in t.with_columns(a=t.col("a") + 1).index_cache
