"""The port's TPC-H slice (generate -> lower -> walk -> operators) against
the JAX reference on the same data, plus the guards the port promises:
no jax import, no silent fallback to the CPU, the explain goldens."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analytics import planner as RP
from repro.analytics import tpch as R
from repro_torch.analytics import planner as TP
from repro_torch.analytics import tpch as T
from repro_torch.core.config import PlacementPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")

# name -> (port context, reference context)
CONTEXTS = {
    "xla": dict(executor="xla"),
    "kernel": dict(executor="kernel"),
    "cost": dict(executor="cost"),
    "join_kernel": dict(executor="cost", join="kernel"),
}
EXACT = ("o_orderkey", "count_order", "_count", "_overflow", "med_qty",
         "med_price")


@pytest.fixture(scope="module")
def data():
    ref = R.generate(scale=0.004, seed=1)
    return ref, T.from_numpy(ref.tables, ref.scale, device="cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_matches_reference_bit_for_bit(seed):
    ref = R.generate(scale=0.002, seed=seed)
    got = T.generate(scale=0.002, seed=seed, device="cpu")
    assert set(got.tables) == set(ref.tables)
    for t, cols in ref.tables.items():
        assert set(got.tables[t]) == set(cols)
        for c, a in cols.items():
            g = got.tables[t][c].numpy()
            assert g.dtype == a.dtype and np.array_equal(g, a), (t, c)


@pytest.mark.parametrize("ctx", sorted(CONTEXTS))
@pytest.mark.parametrize("name", sorted(T.LOGICAL_QUERIES))
def test_run_query_matches_reference(data, name, ctx):
    ref_data, port_data = data
    want = R.run_query(name, ref_data,
                       context=RP.ExecutionContext(**CONTEXTS[ctx]))
    got = T.run_query(name, port_data,
                      context=TP.ExecutionContext(**CONTEXTS[ctx]))
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape, k
        if k in EXACT or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{name}/{k}")
        elif k.startswith("p") and name == "qq":      # interpolated quantiles
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:                                         # f32 sums, any order
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("ctx", sorted(CONTEXTS))
def test_explain_decisions_match_reference(data, ctx):
    ref_data, port_data = data
    for name, plan in T.LOGICAL_QUERIES.items():
        want = RP.explain(R.LOGICAL_QUERIES[name], ref_data.as_jax(),
                          RP.ExecutionContext(**CONTEXTS[ctx]))
        got = TP.explain(plan, port_data.tables,
                         TP.ExecutionContext(**CONTEXTS[ctx]))
        assert [d.describe() for d in got] == [d.describe() for d in want]


GOLDEN_CONTEXTS = {
    "q3": dict(executor="cost", policy=PlacementPolicy.INTERLEAVE,
               dist_join="partitioned"),
    "q5": dict(executor="cost", policy=PlacementPolicy.INTERLEAVE,
               dist_join="partitioned"),
    "qm": dict(executor="cost", policy=PlacementPolicy.INTERLEAVE),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CONTEXTS))
def test_explain_physical_reproduces_reference_goldens(data, name):
    _, port_data = data
    prev = TP.current_cost_profile()
    TP.set_cost_profile(None)
    try:
        got = TP.explain_physical(T.LOGICAL_QUERIES[name], port_data.tables,
                                  TP.ExecutionContext(**GOLDEN_CONTEXTS[name]),
                                  n_shards=4)
    finally:
        TP.set_cost_profile(prev)
    with open(os.path.join(FIXDIR, f"explain_{name}.txt")) as f:
        assert got == f.read().rstrip("\n")


def test_sharded_context_lowers_but_does_not_execute(data):
    """Despite the name (kept so the test keeps its identity), a sharded
    context lowers AND executes on a virtual mesh, and the result must
    equal the single-device one (tests/test_torch_dist.py holds every
    query and policy against the reference)."""
    _, port_data = data
    ctx = TP.ExecutionContext(n_shards=4, policy=PlacementPolicy.INTERLEAVE)
    assert TP.explain(T.LOGICAL_QUERIES["q1"], port_data.tables, ctx)
    got = T.run_query("q1", port_data, context=ctx)
    want = T.run_query("q1", port_data, executor="xla")
    assert set(got) == set(want)
    for k, w in want.items():
        if k in EXACT or not w.is_floating_point():
            assert torch.equal(got[k], w), k
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-3,
                                       rtol=1e-4, err_msg=k)


def test_choose_join_takes_the_kernel_only_for_cuda_tables():
    """Despite the name (kept so the test keeps its identity), the rule
    takes the sorted gather on every device unless the context forces the
    kernel."""
    ctx = TP.ExecutionContext(executor="cost")
    big = (1 << 20, 1 << 15)
    assert TP.choose_join(*big, ctx) == "sorted"
    assert TP.choose_join(100, 1 << 15, ctx) == "sorted"
    assert TP.choose_join(*big, TP.ExecutionContext(executor="kernel")
                          ) == "sorted"
    assert TP.choose_join(*big, TP.ExecutionContext(mode="cuda")) == "sorted"
    assert TP.choose_join(1, 1, TP.ExecutionContext(join="kernel")) == "kernel"
    assert TP.choose_join(*big, TP.ExecutionContext(join="sorted")
                          ) == "sorted"


def test_plan_cache_keys_executor_and_device(data):
    _, port_data = data
    T.clear_plan_cache()
    T.run_query("q1", port_data, executor="xla")
    T.run_query("q1", port_data, executor="xla")
    assert T.plan_cache_size() == 1 and T.plan_cache_info().hits == 1
    T.run_query("q1", port_data, executor="kernel")
    assert T.plan_cache_size() == 2
    sig = TP.table_signature(port_data.tables)
    assert all(s[-1] == "cpu" for s in sig)


def test_join_index_pool_reuses_and_releases_indexes(data):
    import gc
    import weakref
    _, port_data = data
    pool = TP.join_index_pool()
    pool.clear()
    T.run_query("q5", port_data, executor="xla")
    first = pool.builds
    assert first == 4                    # nation, customer, orders, supplier
    rebuilt = {t: dict(cols) for t, cols in port_data.tables.items()}
    T.run_query("q5", rebuilt, executor="kernel")
    T.run_query("q3", port_data, executor="xla")
    assert pool.builds == first
    arr = torch.randperm(1000).int()
    ref = weakref.ref(arr)
    pool.get("t", "k", arr)
    del arr
    gc.collect()
    assert ref() is None                 # the pool must not pin tensors


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.generate(scale=0.001)
    tables = R.generate(scale=0.001, seed=0).tables      # numpy columns
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_query("q6", tables)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.from_numpy(tables, 0.001)


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.analytics.tpch, "
            "repro_torch.analytics.planner, repro_torch.analytics.engine, "
            "repro_torch.analytics.datasets, repro_torch.core.vmesh, "
            "repro_torch.kernels.radix_partition, repro_torch.models.lm, "
            "repro_torch.runtime.serve_loop, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.rglru_scan, "
            "repro_torch.kernels.rwkv6_scan, repro_torch.models.rwkv6\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
