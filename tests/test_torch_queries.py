"""The port's hand-written TPC-H queries (``tpch.q1`` ... ``qq``) against
the reference's on the same numpy data, and against the port's own
planner (``run_query``) under the same executor; the one-column
``hash_aggregate`` wrapper against ``hash_aggregate_multi`` and the
reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analytics import tpch as R
from repro.kernels.hash_aggregate import hash_aggregate as ref_hash_aggregate
from repro_torch.analytics import tpch as T
from repro_torch.kernels import hash_aggregate as HA

EXECUTORS = ("xla", "kernel")
# equal, not close: top-k keys, counts, overflow, medians (a selection)
EXACT = ("o_orderkey", "count_order", "_count", "_overflow", "med_qty",
         "med_price")


@pytest.fixture(scope="module")
def data():
    ref = R.generate(scale=0.004, seed=1)
    return ref, T.from_numpy(ref.tables, ref.scale, device="cpu")


def _hold(got, want, label):
    """Integers and EXACT keys equal; float sums to the reference's
    executor-parity tolerance."""
    assert set(got) == set(want), label
    for k, w in want.items():
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, f"{label}/{k}"
        if k in EXACT or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{label}/{k}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4,
                                       err_msg=f"{label}/{k}")


def test_queries_are_the_references():
    assert sorted(T.QUERIES) == sorted(R.QUERIES) == sorted(T.LOGICAL_QUERIES)


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("name", sorted(R.QUERIES))
def test_imperative_query_matches_reference(data, name, executor):
    ref_data, port_data = data
    want = R.QUERIES[name](ref_data.as_jax(), executor=executor)
    got = T.QUERIES[name](port_data.tables, executor=executor)
    _hold(got, want, f"{name}/{executor}")


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("name", sorted(R.QUERIES))
def test_imperative_query_matches_run_query(data, name, executor):
    _, port_data = data
    want = T.run_query(name, port_data, executor=executor)
    got = T.QUERIES[name](port_data.tables, executor=executor)
    _hold(got, want, f"{name}/{executor}")


def test_q3_top_k_breaks_ties_to_the_lowest_key():
    """Orders of equal revenue are taken lowest key first (lax.top_k),
    whatever their position in a sort of the revenues."""
    n_ord = 40
    tables = {
        "customer": {"c_custkey": torch.arange(4, dtype=torch.int32),
                     "c_mktsegment": torch.ones(4, dtype=torch.int32)},
        "orders": {"o_orderkey": torch.arange(n_ord, dtype=torch.int32),
                   "o_custkey": torch.arange(n_ord, dtype=torch.int32) % 4,
                   "o_orderdate": torch.zeros(n_ord, dtype=torch.int32)},
        "lineitem": {"l_orderkey": torch.arange(n_ord - 1, -1, -1,
                                                dtype=torch.int32),
                     "l_shipdate": torch.full((n_ord,), T.DATE1,
                                              dtype=torch.int32),
                     "l_extendedprice": torch.full((n_ord,), 100.0),
                     "l_discount": torch.zeros(n_ord)},
    }
    got = T.q3(tables)
    want = R.q3({t: {c: jnp.asarray(v.numpy()) for c, v in cols.items()}
                 for t, cols in tables.items()})
    assert got["o_orderkey"].tolist() == list(range(10))
    np.testing.assert_array_equal(got["o_orderkey"].numpy(),
                                  np.asarray(want["o_orderkey"]))


def test_q18_having_replaces_the_orders_selection(data):
    """q18's HAVING is the orders' whole mask, and the per-order pass's
    overflow is added into the result's."""
    _, port_data = data
    for executor in EXECUTORS:
        out = T.q18(port_data.tables, executor=executor, qty_threshold=0.0)
        li = port_data.tables["lineitem"]
        od = port_data.tables["orders"]
        n_ord = od["o_orderkey"].shape[0]
        has_rows = torch.bincount(li["l_orderkey"].long(), minlength=n_ord) > 0
        want = torch.bincount(od["o_custkey"].long(), weights=has_rows.double(),
                              minlength=out["_count"].shape[0])
        np.testing.assert_array_equal(out["_count"].numpy(),
                                      want.float().numpy())
        assert out["_overflow"].dtype == torch.int32
        assert int(out["_overflow"]) == 0


def test_q6_takes_any_executor_and_returns_one_value(data):
    _, port_data = data
    a = T.q6(port_data.tables, executor="xla")
    b = T.q6(port_data.tables, executor="kernel")
    assert set(a) == {"revenue"} and a["revenue"].shape == (1,)
    assert torch.equal(a["revenue"], b["revenue"])


# (P, T, n_bins, ids lower bound, ids upper bound)
AGG_CASES = [(1, 1000, 128, 0, 128), (4, 3000, 200, -5, 205),
             (3, 777, 64, 0, 64), (2, 0, 16, 0, 16)]


@pytest.mark.parametrize("P,T_,n_bins,lo,hi", AGG_CASES)
def test_hash_aggregate_is_one_column_of_the_multi(P, T_, n_bins, lo, hi):
    rng = np.random.RandomState(P * 31 + T_)
    ids = torch.from_numpy(rng.randint(lo, hi, (P, T_)).astype(np.int32))
    vals = torch.from_numpy((rng.randn(P, T_) * 100).astype(np.float32))
    got = HA.hash_aggregate(ids, vals, n_bins=n_bins)
    multi = HA.hash_aggregate_multi(ids, vals[..., None], n_bins=n_bins)
    assert got.shape == (P, n_bins) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), multi[..., 0].view(torch.int32))


@pytest.mark.parametrize("integral", [True, False])
@pytest.mark.parametrize("P,T_,n_bins,lo,hi", AGG_CASES)
def test_hash_aggregate_matches_reference(P, T_, n_bins, lo, hi, integral):
    """Ids out of range add nothing on both sides. Integer-valued sums are
    exact in f32, so they are equal; others agree to f32 rounding."""
    rng = np.random.RandomState(P * 17 + T_)
    ids = rng.randint(lo, hi, (P, T_)).astype(np.int32)
    vals = (rng.randint(-50, 50, (P, T_)) if integral
            else rng.randn(P, T_) * 100).astype(np.float32)
    want = np.asarray(ref_hash_aggregate(ids, vals, n_bins=n_bins,
                                         mode="ref"))
    got = HA.hash_aggregate(torch.from_numpy(ids), torch.from_numpy(vals),
                            n_bins=n_bins).numpy()
    if integral:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
