"""The chaos grid of the reference's ``tests/test_service_faults.py`` on
the port's serving tier, on the CPU at scale 0.004 (seed 1).

Seeded fault scenarios (transient and persistent build failure, wait
poison, mid-round pool kill, straggling pool), each on both dispatch
modes (whole-plan and morsel-split), plus a seeded chaos storm. Under
every scenario:

  * every submitted request gets EXACTLY ONE terminal QueryResult;
  * surviving results are bit-identical to a fault-free run of the same
    dispatch mode (whole-plan == the port's serial run_query; morsel-split
    == its own morsel-order merge), and within the executor-parity
    tolerance of the reference's run_query;
  * stats conserve: admitted == completed + failed + expired + shed;
  * the injector's counters record what fired, and a replay with the same
    seed fires the same faults.
"""
import numpy as np
import pytest
import torch

from repro.analytics import planner as RP
from repro.analytics import tpch as R
from repro_torch.analytics.planner import ExecutionContext
from repro_torch.analytics.service import (AnalyticsService, RetryPolicy,
                                           ServiceConfig,
                                           ServiceFaultInjector,
                                           ThreadPlacement)
from repro_torch.analytics.tpch import (LOGICAL_QUERIES, from_numpy,
                                        run_query, submit_query)

# dispatch modes: whole-plan (bit-identical to serial) and morsel-split
# (deterministic morsel-order merge; 997 does not divide the row count)
MODES = {"whole": None, "morsel": 997}
EXACT = ("o_orderkey", "count_order", "_count", "_overflow", "med_qty",
         "med_price", "p90_price", "p25_qty")


@pytest.fixture(scope="module")
def ref_data():
    return R.generate(scale=0.004, seed=1)


@pytest.fixture(scope="module")
def data(ref_data):
    return from_numpy(ref_data.tables, ref_data.scale, device="cpu")


@pytest.fixture(scope="module")
def refs(data):
    """Fault-free references per mode: serial run_query for whole-plan, a
    clean served morsel run for morsel-split (a different float order
    than serial, but the same bits on every run)."""
    ctx = _ctx()
    out = {"whole": {n: run_query(n, data, context=ctx)
                     for n in LOGICAL_QUERIES}}
    with AnalyticsService(ServiceConfig(
            n_pools=2, workers_per_pool=2, morsel_rows=MODES["morsel"],
            placement=ThreadPlacement.SPARSE)) as svc:
        rids = {n: submit_query(svc, n, data, context=ctx)
                for n in LOGICAL_QUERIES}
        results = svc.drain()
    out["morsel"] = {n: results[rid].value for n, rid in rids.items()}
    return out


def _config(mode, faults, **kw):
    kw.setdefault("n_pools", 2)
    kw.setdefault("workers_per_pool", 2)
    kw.setdefault("placement", ThreadPlacement.SPARSE)
    kw.setdefault("retry", RetryPolicy(max_attempts=3, base_backoff_s=0.005,
                                       max_backoff_s=0.05))
    return ServiceConfig(morsel_rows=MODES[mode], faults=faults, **kw)


def _ctx():
    return ExecutionContext(executor="xla")


def _assert_identical(got, ref, label):
    assert got is not None, f"{label}: no value"
    assert set(got) == set(ref), label
    for k in ref:
        assert torch.equal(got[k], ref[k]), f"{label}/{k}"


def _assert_conserved(st):
    assert st.admitted == (st.completed + st.failed + st.expired + st.shed), \
        st.describe()


@pytest.mark.parametrize("mode", list(MODES))
def test_fault_free_modes_agree_with_the_reference(ref_data, refs, mode):
    rctx = RP.ExecutionContext(executor="xla")
    for name, got in refs[mode].items():
        want = R.run_query(name, ref_data, context=rctx)
        assert set(got) == set(want), name
        for k, w in want.items():
            w, g = np.asarray(w), got[k].numpy()
            if k in EXACT or w.dtype.kind in "iub":
                np.testing.assert_array_equal(g, w, err_msg=f"{name}/{k}")
            else:
                np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4,
                                           err_msg=f"{name}/{k}")


@pytest.mark.parametrize("mode", list(MODES))
def test_transient_build_failure_is_retried(data, refs, mode):
    faults = ServiceFaultInjector(seed=3, build_fail_at={0})
    with AnalyticsService(_config(mode, faults)) as svc:
        rid = submit_query(svc, "q6", data, context=_ctx())
        res = svc.drain()[rid]
        st = svc.stats()
    _assert_identical(res.value, refs[mode]["q6"], f"{mode}/transient")
    assert res.error is None and res.attempts == 2
    assert faults.builds_failed == 1
    assert st.retries == 1 and st.failed == 0 and st.completed == 1
    _assert_conserved(st)


@pytest.mark.parametrize("mode", list(MODES))
def test_persistent_build_failure_is_isolated(data, refs, mode):
    faults = ServiceFaultInjector(seed=3, build_fail_at={0, 1, 2})
    with AnalyticsService(_config(mode, faults)) as svc:
        bad = submit_query(svc, "q6", data, context=_ctx())
        good = submit_query(svc, "q1", data, context=_ctx())
        results = svc.drain()
        st = svc.stats()
    assert results[bad].value is None
    assert "InjectedServiceFault" in results[bad].error
    assert results[bad].attempts == 3
    _assert_identical(results[good].value, refs[mode]["q1"],
                      f"{mode}/survivor")
    assert faults.builds_failed == 3
    assert st.failed == 1 and st.completed == 1 and st.retries == 2
    _assert_conserved(st)


@pytest.mark.parametrize("mode", list(MODES))
def test_poisoned_wait_is_retried(data, refs, mode):
    faults = ServiceFaultInjector(seed=3, poison_wait_at={0})
    with AnalyticsService(_config(mode, faults)) as svc:
        rid = submit_query(svc, "q6", data, context=_ctx())
        res = svc.drain()[rid]
        st = svc.stats()
    _assert_identical(res.value, refs[mode]["q6"], f"{mode}/poison")
    assert res.attempts == 2 and faults.waits_poisoned == 1
    assert st.retries == 1 and st.failed == 0 and st.dispatches == 2
    _assert_conserved(st)


@pytest.mark.parametrize("mode", list(MODES))
def test_pool_kill_mid_round_keeps_serving(data, refs, mode):
    faults = ServiceFaultInjector(seed=3, kill_pool_at=(0, 1))
    with AnalyticsService(_config(mode, faults)) as svc:
        rids = {n: submit_query(svc, n, data, context=_ctx())
                for n in LOGICAL_QUERIES}
        results = svc.drain()
        late = submit_query(svc, "q6", data, context=_ctx())
        results.update(svc.drain())
        st = svc.stats()
    assert faults.pools_killed == 1
    assert st.dead_pools == (1,) and 1 in st.quarantined_pools
    for name, rid in rids.items():
        _assert_identical(results[rid].value, refs[mode][name],
                          f"{mode}/kill/{name}")
    _assert_identical(results[late].value, refs[mode]["q6"],
                      f"{mode}/kill/late")
    assert st.completed == len(LOGICAL_QUERIES) + 1 and st.failed == 0
    _assert_conserved(st)


@pytest.mark.parametrize("mode", list(MODES))
def test_straggler_pool_is_quarantined(data, refs, mode):
    """Pool 1 sleeps 60 ms per work unit (host sleep: the tables lie on
    the CPU); the EWMA sweep quarantines it mid-drain and pool 0 finishes
    the backlog. Stealing is off, as in the reference: an idle fast pool
    would otherwise take the straggler's backlog before it accumulates
    warm-up samples."""
    faults = ServiceFaultInjector(seed=3, straggle_pool=(1, 0.06))
    cfg = _config(mode, faults, batching=False, straggler_warmup=2,
                  straggler_threshold=4.0, workers_per_pool=1, steal=False)
    n_reqs = 12
    with AnalyticsService(cfg) as svc:
        rids = [submit_query(svc, "q6", data, context=_ctx())
                for _ in range(n_reqs)]
        results = svc.drain()
        st = svc.stats()
    assert 1 in st.quarantined_pools, st.describe()
    assert st.dead_pools == ()
    for i, rid in enumerate(rids):
        _assert_identical(results[rid].value, refs[mode]["q6"],
                          f"{mode}/straggle/{i}")
    assert st.completed == n_reqs and st.failed == 0
    _assert_conserved(st)


def _storm(mode, data, seed):
    faults = ServiceFaultInjector(seed=seed, build_fail_rate=0.15,
                                  poison_rate=0.10)
    cfg = _config(mode, faults,
                  retry=RetryPolicy(max_attempts=4, base_backoff_s=0.002,
                                    max_backoff_s=0.02))
    names = list(LOGICAL_QUERIES) * 3         # 21 requests
    with AnalyticsService(cfg) as svc:
        rids = [submit_query(svc, n, data, context=_ctx(),
                             client_id=i % 3, priority=1 + i % 2)
                for i, n in enumerate(names)]
        results = svc.drain()
        st = svc.stats()
    return names, rids, results, st, faults


@pytest.mark.parametrize("mode", list(MODES))
def test_chaos_storm_exactly_one_terminal_result(data, refs, mode):
    names, rids, results, st, faults = _storm(mode, data, seed=11)
    assert sorted(results) == sorted(rids)
    for name, rid in zip(names, rids):
        res = results[rid]
        states = [res.value is not None, res.error is not None,
                  res.expired, res.shed]
        assert sum(states) == 1, f"rid {rid}: not exactly-one terminal"
        if res.value is not None:
            _assert_identical(res.value, refs[mode][name],
                              f"{mode}/storm/{name}")
    assert st.completed + st.failed == len(rids)
    assert faults.builds_failed + faults.waits_poisoned > 0
    _assert_conserved(st)


@pytest.mark.parametrize("mode", list(MODES))
def test_chaos_storm_replays_deterministically(data, mode):
    runs = [_storm(mode, data, seed=11) for _ in range(2)]
    (_, rids_a, res_a, _, f_a), (_, rids_b, res_b, _, f_b) = runs
    assert (f_a.builds_failed, f_a.waits_poisoned) == \
        (f_b.builds_failed, f_b.waits_poisoned)
    assert [res_a[r].attempts for r in rids_a] == \
        [res_b[r].attempts for r in rids_b]
    assert [res_a[r].error is None for r in rids_a] == \
        [res_b[r].error is None for r in rids_b]
