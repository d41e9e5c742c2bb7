"""The port's serving tier (``repro_torch.analytics.service``) and its
planner, engine and tpch seams, on the CPU at scale 0.004 (seed 1, as the
reference's service tests).

Self-promises, bit for bit: served results equal the port's own serial
``run_query`` on the whole-plan and split-probe paths under every
ThreadPlacement, and distributive morsels give the same bits under every
placement. Against the reference on the same numpy: morsel boundaries,
``probe_split``, ``JoinIndexPool`` base and replicas, the retry backoff
floats, the admission queue's dequeue order, the adaptive window, the
fault schedule, and served results within the executor-parity tolerance
(integers, masks and row orders equal; float sums within atol=1e-3,
rtol=1e-4).
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.analytics import engine as RE
from repro.analytics import planner as RP
from repro.analytics import tpch as R
from repro.analytics.service import batcher as RB
from repro.analytics.service import faults as RF
from repro.analytics.service import queue as RQ
from repro.analytics.service import retry as RR
from repro.analytics.service import scheduler as RS
from repro_torch.analytics import engine as TE
from repro_torch.analytics import physical as PH
from repro_torch.analytics import planner as TP
from repro_torch.analytics import telemetry, tracing
from repro_torch.analytics import tpch as T
from repro_torch.analytics.service import queue as TQ
from repro_torch.analytics.service import (AdaptiveBatchWindow,
                                           AnalyticsService,
                                           MorselScheduler, QueryBatcher,
                                           QueryRequest, RetryPolicy,
                                           ServiceConfig,
                                           ServiceFaultInjector,
                                           ThreadPlacement, WorkerLeakError)

EXACT = ("o_orderkey", "count_order", "_count", "_overflow", "med_qty",
         "med_price", "p90_price", "p25_qty")


@pytest.fixture(scope="module")
def data():
    ref = R.generate(scale=0.004, seed=1)
    return ref, T.from_numpy(ref.tables, ref.scale, device="cpu")


@pytest.fixture(autouse=True)
def _restore_planner_config():
    yield
    TP.configure_plan_cache(TP.DEFAULT_PLAN_CACHE_ENTRIES)
    TP.set_cost_profile(None)


def _same_bits(got, want, label):
    assert set(got) == set(want), label
    for k, w in want.items():
        assert got[k].dtype == w.dtype, f"{label}/{k}"
        assert torch.equal(torch.nan_to_num(got[k], nan=-7.0),
                           torch.nan_to_num(w, nan=-7.0)), f"{label}/{k}"


def _near_reference(got, want, label):
    """Integers, counts and order statistics equal; float sums within the
    executor-parity tolerance."""
    assert set(got) == set(want), label
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape, f"{label}/{k}"
        if k in EXACT or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{label}/{k}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4,
                                       err_msg=f"{label}/{k}")


def _rows(port_data):
    li = port_data.tables["lineitem"]["l_orderkey"].shape[0]
    od = port_data.tables["orders"]["o_orderkey"].shape[0]
    return li, od


# ---------------------------------------------------------------------------
# served == serial, bit for bit; near the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("placement", list(ThreadPlacement))
def test_served_bit_identical_all_queries(data, placement):
    ref_data, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    serial = {n: T.run_query(n, port_data, context=ctx)
              for n in T.LOGICAL_QUERIES}
    with AnalyticsService(ServiceConfig(n_pools=2, workers_per_pool=2,
                                        placement=placement)) as svc:
        rids = {n: T.submit_query(svc, n, port_data, context=ctx)
                for n in T.LOGICAL_QUERIES}
        results = svc.drain()
        st = svc.stats()
    assert st.completed == len(T.LOGICAL_QUERIES)
    for name, rid in rids.items():
        _same_bits(results[rid].value, serial[name],
                   f"{name}/{placement.value}")
    if placement == ThreadPlacement.OS_DEFAULT:
        rctx = RP.ExecutionContext(executor="cost")
        for name, rid in rids.items():
            _near_reference(results[rid].value,
                            R.run_query(name, ref_data, context=rctx), name)


def test_submit_query_defaults_match_run_query(data):
    _, port_data = data
    ref = T.run_query("q6", port_data)
    with AnalyticsService(ServiceConfig(n_pools=1,
                                        workers_per_pool=1)) as svc:
        rid = T.submit_query(svc, "q6", port_data)
        got = svc.drain()[rid].value
    _same_bits(got, ref, "defaults")


def test_submit_query_places_numpy_on_the_named_device(data):
    """numpy columns go to ``device`` (the CPU here, as asked); without a
    GPU the default (CUDA) raises instead of falling back."""
    ref_data, port_data = data
    want = T.run_query("q6", port_data)
    with AnalyticsService(ServiceConfig(n_pools=1,
                                        workers_per_pool=1)) as svc:
        rid = T.submit_query(svc, "q6", ref_data.tables, device="cpu")
        got = svc.drain()[rid].value
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                T.submit_query(svc, "q6", ref_data.tables)
    _same_bits(got, want, "numpy input")


# ---------------------------------------------------------------------------
# morsels: boundaries, merge, placement-independent bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_rows,morsel_rows", [
    (10, None), (10, 100), (10, 10), (10, 4), (12, 4), (24_000, 997),
    (24_000, 500), (1, 1)])
def test_morsel_slices_match_reference(n_rows, morsel_rows):
    assert TE.morsel_slices(n_rows, morsel_rows) == \
        RE.morsel_slices(n_rows, morsel_rows)


def test_morsel_slices_and_merge_reject_what_the_reference_rejects():
    with pytest.raises(ValueError):
        TE.morsel_slices(10, 0)
    with pytest.raises(ValueError):
        TE.merge_morsel_partials([])


def test_morsel_slice_columns_are_views():
    cols = {"a": torch.arange(10, dtype=torch.int32),
            "b": torch.arange(10, dtype=torch.float32) / 3}
    got = TE.morsel_slice_columns(cols, 4, 3)
    for c, a in got.items():
        assert torch.equal(a, cols[c][4:7])
        assert a.data_ptr() == cols[c][4:].data_ptr()     # narrow: no copy


def test_merge_morsel_partials_matches_reference():
    """Sums fold left in morsel order; split-probe slices concatenate in
    order, keeping dtypes and a None mask."""
    rng = np.random.RandomState(3)
    sums = [(rng.randn(6, 3) * 1e4).astype(np.float32) for _ in range(5)]
    ovf = [np.int32(i) for i in range(5)]
    want_s, want_o = RE.merge_morsel_partials(list(zip(sums, ovf)))
    got_s, got_o = TE.merge_morsel_partials(
        [(torch.from_numpy(s), torch.tensor(o)) for s, o in zip(sums, ovf)])
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert int(got_o) == int(want_o)
    for masked in (True, False):
        parts = [({"k": rng.randint(0, 9, n).astype(np.int32),
                   "v": rng.randn(n).astype(np.float32)},
                  rng.rand(n).astype(np.float32) if masked else None)
                 for n in (4, 1, 7)]
        (wc, wm), _ = RE.merge_morsel_partials(
            [(p, np.int32(0)) for p in parts])
        (gc, gm), _ = TE.merge_morsel_partials(
            [(({c: torch.from_numpy(a) for c, a in cols.items()},
               None if m is None else torch.from_numpy(m)),
              torch.tensor(0, dtype=torch.int32)) for cols, m in parts])
        assert (gm is None) == (wm is None)
        if gm is not None:
            assert np.array_equal(gm.numpy(), np.asarray(wm))
        for c in wc:
            assert gc[c].numpy().dtype == np.asarray(wc[c]).dtype
            assert np.array_equal(gc[c].numpy(), np.asarray(wc[c]))


@pytest.mark.parametrize("morsel_rows", [500, 997, 1000])
def test_distributive_morsels_are_placement_independent(data, morsel_rows):
    """q1/q6 under the kernel executor (the morsel partials go through
    ``hash_aggregate_multi``'s plain version here): the same bits under
    every placement, whatever pool ran which morsel; the exact morsel
    count (997 leaves a short tail morsel); within tolerance of the
    reference's one-pass plan."""
    ref_data, port_data = data
    n_li, _ = _rows(port_data)
    per_placement = {}
    for placement in ThreadPlacement:
        with AnalyticsService(ServiceConfig(
                n_pools=2, workers_per_pool=2, morsel_rows=morsel_rows,
                placement=placement)) as svc:
            rids = {n: T.submit_query(svc, n, port_data, executor="kernel")
                    for n in ("q1", "q6")}
            results = svc.drain()
            st = svc.stats()
        assert st.morsels == 2 * -(-n_li // morsel_rows)
        per_placement[placement] = {n: results[r].value
                                    for n, r in rids.items()}
    first = per_placement[ThreadPlacement.OS_DEFAULT]
    for placement, got in per_placement.items():
        for n in got:
            _same_bits(got[n], first[n], f"{n}/{placement.value}")
    for n in first:
        _near_reference(first[n], R.run_query(n, ref_data, executor="kernel"),
                        n)


def test_split_probe_plans_serve_bit_identical(data):
    """q3/q5/q18 become split-probe tasks at morsel_rows=1000: the
    reference's exact morsel count (q3 and q5 probe lineitem, q18 orders)
    and the port's serial bits."""
    ref_data, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    serial = {n: T.run_query(n, port_data, context=ctx)
              for n in ("q3", "q5", "q18")}
    with AnalyticsService(ServiceConfig(n_pools=2, workers_per_pool=1,
                                        morsel_rows=1000)) as svc:
        rids = {n: T.submit_query(svc, n, port_data, context=ctx)
                for n in serial}
        results = svc.drain()
        st = svc.stats()
    n_li, n_ord = _rows(port_data)
    assert st.morsels == 2 * -(-n_li // 1000) + -(-n_ord // 1000)
    with RS.MorselScheduler(n_pools=2, workers_per_pool=1, morsel_rows=1000,
                            n_shards=1, started=False) as rsched:
        ref_count = sum(len(rsched.build_task(
            R.LOGICAL_QUERIES[n], ref_data.as_jax(),
            RP.ExecutionContext(executor="cost")).morsels) for n in serial)
    assert st.morsels == ref_count
    for name, rid in rids.items():
        _same_bits(results[rid].value, serial[name], name)


@pytest.mark.parametrize("placement", list(ThreadPlacement))
def test_split_probe_bit_identical_under_every_placement(data, placement):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    tables = port_data.tables
    for name in ("q3", "q5", "q18"):
        serial = T.run_query(name, port_data, context=ctx)
        with MorselScheduler(n_pools=2, workers_per_pool=2,
                             morsel_rows=1000, placement=placement) as sched:
            task = sched.build_task(T.LOGICAL_QUERIES[name], tables, ctx)
            assert task.split and task.compiled is None, name
            assert len(task.morsels) >= 2, name
            got = sched.submit(task).wait(timeout=120)
            st = sched.stats()
        assert sum(st.executed_per_pool) == st.morsels_dispatched
        assert 0 <= st.steals <= st.morsels_dispatched
        _same_bits(got, serial, f"{name}/{placement.value}")


def test_sub_threshold_probes_serve_whole(data):
    _, port_data = data
    TP.set_cost_profile(dataclasses.replace(
        TP.current_cost_profile(), morsel_split_rows=1 << 30))
    ctx = TP.ExecutionContext(executor="cost")
    serial = {n: T.run_query(n, port_data, context=ctx)
              for n in ("q3", "q5", "q18")}
    with AnalyticsService(ServiceConfig(n_pools=2, workers_per_pool=1,
                                        morsel_rows=1000)) as svc:
        rids = {n: T.submit_query(svc, n, port_data, context=ctx)
                for n in serial}
        results = svc.drain()
        st = svc.stats()
    assert st.morsels == len(serial)          # one whole-plan morsel each
    for name, rid in rids.items():
        _same_bits(results[rid].value, serial[name], name)


# ---------------------------------------------------------------------------
# planner seams against the reference
# ---------------------------------------------------------------------------
def _probe_split_shape(split):
    if split is None:
        return None
    return (split.scan.table, split.n_rows,
            [(p.is_table, p.index) for p in split.preludes])


@pytest.mark.parametrize("ctx_kw", [dict(executor="cost"),
                                    dict(executor="xla"),
                                    dict(executor="kernel"),
                                    dict(executor="cost", join="kernel")])
def test_probe_split_matches_reference(data, ctx_kw):
    ref_data, port_data = data
    rows = TP._true_rows(port_data.tables)
    for name in T.LOGICAL_QUERIES:
        got = TP.probe_split(TP.lower(T.LOGICAL_QUERIES[name],
                                      TP.ExecutionContext(**ctx_kw), rows))
        want = RP.probe_split(RP.lower(R.LOGICAL_QUERIES[name],
                                       RP.ExecutionContext(**ctx_kw), rows))
        assert _probe_split_shape(got) == _probe_split_shape(want), name


def test_probe_split_declines_where_the_reference_declines(data):
    _, port_data = data
    rows = TP._true_rows(port_data.tables)
    ctx = TP.ExecutionContext(executor="cost")
    q3 = T.LOGICAL_QUERIES["q3"]
    assert TP.probe_split(TP.lower(q3, ctx, rows)) is not None
    assert TP.probe_split(TP.lower(q3, ctx, rows, n_shards=4)) is None
    big = dataclasses.replace(TP.current_cost_profile(),
                              morsel_split_rows=1 << 30)
    phys = TP.lower(q3, ctx, rows, big)
    assert not any(n.morsel_split for n in PH.walk_unique(phys.root)
                   if isinstance(n, PH.PJoin))
    assert TP.probe_split(phys) is None
    assert TP.probe_split(TP.lower(q3, TP.ExecutionContext(
        executor="cost", join="kernel"), rows)) is None
    assert TP.probe_split(TP.lower(T.LOGICAL_QUERIES["q1"], ctx,
                                   rows)) is None
    split = TP.probe_split(TP.lower(T.LOGICAL_QUERIES["q5"], ctx, rows))
    assert split.scan.table == "lineitem"
    assert [p.index for p in split.preludes if p.index is not None] == \
        [("supplier", "s_suppkey"), ("orders", "o_orderkey")]


def test_join_index_pool_replicas_match_reference(data):
    ref_data, port_data = data
    rpool, tpool = RP.join_index_pool(), TP.join_index_pool()
    rpool.clear()
    tpool.clear()
    for table, column in (("orders", "o_orderkey"), ("supplier",
                                                     "s_suppkey")):
        rarr = ref_data.as_jax()[table][column]
        tarr = port_data.tables[table][column]
        want = [rpool.get(table, column, rarr)] + [
            rpool.replica(table, column, rarr, p) for p in (0, 1)]
        base = tpool.get(table, column, tarr)
        reps = [tpool.replica(table, column, tarr, p) for p in (0, 1)]
        for got, w in zip([base] + reps, want):
            for g, x in zip(got, w):
                assert np.array_equal(g.numpy(), np.asarray(x)), (table, column)
        assert reps[0][0] is not reps[1][0] and reps[0][0] is not base[0]
        assert reps[0][0].data_ptr() != base[0].data_ptr()
        tpool.replica(table, column, tarr, 0)        # a hit, no new replica
    assert (tpool.builds, tpool.replicas) == (rpool.builds, rpool.replicas)
    assert tpool.replicas == 4


def test_build_side_replicated_once_per_pool(data):
    _, port_data = data
    pool = TP.join_index_pool()
    pool.clear()
    TP.clear_plan_cache()
    ctx = TP.ExecutionContext(executor="cost")
    tables = port_data.tables
    with MorselScheduler(n_pools=2, workers_per_pool=2, morsel_rows=1000,
                         placement=ThreadPlacement.SPARSE) as sched:
        task = sched.build_task(T.LOGICAL_QUERIES["q3"], tables, ctx)
        assert len(task.morsels) >= 4
        sched.submit(task).wait(timeout=120)
        assert pool.replicas == 2               # one per pool, per column
        builds = pool.builds
        sched.submit(sched.build_task(T.LOGICAL_QUERIES["q3"], tables,
                                      ctx)).wait(timeout=120)
    assert pool.replicas == 2 and pool.builds == builds


def test_cached_executable_shares_the_plan_cache():
    TP.clear_plan_cache()
    made = []
    key = ("test-tag", 1)
    f1 = TP.cached_executable(key, lambda: made.append(1) or (lambda: 7))
    f2 = TP.cached_executable(key, lambda: made.append(1) or (lambda: 8))
    assert f1 is f2 and f1() == 7 and made == [1]
    assert TP.plan_cache_size() == 1


def test_executor_without_tables_takes_the_given_device():
    ex = TP._LocalExecutor({}, TP.ExecutionContext(), {},
                           device=torch.device("cpu"))
    assert ex.device == torch.device("cpu")
    assert ex.overflow.device == torch.device("cpu")


def test_pool_shard_ranges_match_reference():
    for n_pools, n_shards in ((2, 4), (3, 8), (2, 1), (4, 4)):
        got = MorselScheduler(n_pools=n_pools, n_shards=n_shards,
                              started=False)
        want = RS.MorselScheduler(n_pools=n_pools, n_shards=n_shards,
                                  started=False)
        assert [(p.shard_lo, p.shard_hi) for p in got.pools] == \
            [(p.shard_lo, p.shard_hi) for p in want.pools]
    one = MorselScheduler(n_pools=2, started=False)     # one device
    assert [(p.shard_lo, p.shard_hi) for p in one.pools] == [(0, 1), (1, 1)]


# ---------------------------------------------------------------------------
# retry, queue, batcher, faults: against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jitter", [0.0, 0.5, 1.0])
def test_retry_backoff_matches_reference(jitter):
    kw = dict(max_attempts=5, base_backoff_s=0.01, multiplier=2.0,
              max_backoff_s=0.05, jitter=jitter)
    got, want = RetryPolicy(**kw), RR.RetryPolicy(**kw)
    for attempt in range(1, 8):
        for key in (0, 1, 7, 12345, 2 ** 31 + 5):
            assert got.backoff_s(attempt, key) == want.backoff_s(attempt,
                                                                 key)
            for now, dl in ((0.0, None), (0.0, 0.02), (1.0, 1.001)):
                assert got.should_retry(attempt, now, dl, key) == \
                    want.should_retry(attempt, now, dl, key)
    for bad in (dict(max_attempts=0), dict(jitter=1.5)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)


def _queue_script(mod_queue, seed):
    """A seeded mix of priorities, clients and deadlines offered to a
    bounded, shedding queue under injected clocks; returns every id order
    and the stats."""
    rng = np.random.RandomState(seed)
    q = mod_queue.AdmissionQueue(max_depth=24, shed_watermark=16,
                                 client_weights={1: 2, 3: 3})
    log = []
    now = 0.0
    for step in range(12):
        for _ in range(rng.randint(1, 8)):
            rid = len(log) + 1000 * step
            dl = None if rng.rand() < 0.6 else now + rng.uniform(-0.5, 2.0)
            ok = q.offer(mod_queue.QueryRequest(
                rid, None, {}, None, deadline_s=dl,
                client_id=int(rng.randint(0, 4)),
                priority=int(rng.randint(0, 3))), now=now)
            log.append(("offer", rid, ok))
        log.append(("shed", [r.req_id for r in q.pop_overload_shed()]))
        now += rng.uniform(0.0, 0.6)
        live, expired = q.take_batch(int(rng.randint(1, 6)), now=now)
        log.append(("take", [r.req_id for r in live],
                    [r.req_id for r in expired]))
        if step % 3 == 2:
            log.append(("sweep", [r.req_id for r in q.shed_expired(now)]))
    st = q.stats()
    st.queue_wait_total_s = round(st.queue_wait_total_s, 9)
    return log, st.__dict__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_queue_take_batch_matches_reference(seed):
    got_log, got_st = _queue_script(TQ, seed)
    want_log, want_st = _queue_script(RQ, seed)
    assert got_log == want_log
    assert got_st == want_st
    assert got_st["admitted"] == (got_st["dequeued"] + got_st["expired"]
                                  + got_st["shed_overload"]
                                  + got_st["depth"])


def test_adaptive_batch_window_matches_reference():
    rng = np.random.RandomState(5)
    backlogs = [int(x) for x in rng.choice([0, 0, 1, 3, 9, 40, 200], 60)]
    for lo, hi in ((1, 16), (2, 64), (1, 1)):
        got, want = AdaptiveBatchWindow(lo, hi), RB.AdaptiveBatchWindow(lo,
                                                                        hi)
        assert [got.observe(b) for b in backlogs] == \
            [want.observe(b) for b in backlogs]
    with pytest.raises(ValueError):
        AdaptiveBatchWindow(0, 4)


def test_fault_injector_schedule_matches_reference():
    kw = dict(seed=11, build_fail_at={2, 9}, poison_wait_at={4},
              build_fail_rate=0.2, poison_rate=0.15)
    got, want = ServiceFaultInjector(**kw), RF.ServiceFaultInjector(**kw)
    trail = []
    for inj, exc in ((got, Exception), (want, Exception)):
        seq = []
        for _ in range(40):
            try:
                seq.append(("ok", inj.begin_dispatch()))
            except exc as e:
                seq.append(("fail", type(e).__name__))
        seq.append(sorted(inj._poison_pending))
        seq.append((inj.builds_failed, inj._ordinal))
        trail.append(seq)
    assert trail[0] == trail[1]
    assert got.morsel_delay(0) == want.morsel_delay(0) == 0.0
    s = ServiceFaultInjector(straggle_pool=(1, 0.25))
    assert (s.morsel_delay(0), s.morsel_delay(1)) == (0.0, 0.25)


def test_batcher_key_grouping(data):
    _, port_data = data
    tables = port_data.tables
    ctx_a = TP.ExecutionContext(executor="cost")
    ctx_b = TP.ExecutionContext(executor="xla")
    rebuilt = {t: dict(cols) for t, cols in tables.items()}
    q = T.LOGICAL_QUERIES
    reqs = [QueryRequest(0, q["q1"], tables, ctx_a),
            QueryRequest(1, q["q1"], tables, ctx_a),       # dedup peer
            QueryRequest(2, q["q1"], tables, ctx_b),       # other ctx
            QueryRequest(3, q["q3"], tables, ctx_a),       # other plan
            QueryRequest(4, q["q1"], rebuilt, ctx_a)]      # other mapping
    b = QueryBatcher()
    groups = b.group(reqs)
    assert len(groups) == 3
    q1a = [g for g in groups if g.requests[0].req_id == 0][0]
    assert sorted(r.req_id for r in q1a.requests) == [0, 1, 4]
    assert sorted(len(s) for s in q1a.shares) == [1, 2]
    st = b.stats()
    assert st.batches == 3 and st.batched_queries == 3
    # the key is the plan-cache key's triple: the signature names the device
    assert QueryBatcher.batch_key(reqs[0])[2] == TP.table_signature(tables)


# ---------------------------------------------------------------------------
# the service's own behaviour (the reference's service tests, ported)
# ---------------------------------------------------------------------------
def test_batched_service_dedups_hot_path(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    ref = T.run_query("q1", port_data, context=ctx)
    with AnalyticsService(ServiceConfig(n_pools=2,
                                        workers_per_pool=2)) as svc:
        rids = [T.submit_query(svc, "q1", port_data, context=ctx)
                for _ in range(32)]
        results = svc.drain()
        st = svc.stats()
    assert st.completed == 32 and st.dispatches == 1 and st.dedup_hits == 31
    for rid in rids:
        assert results[rid].batch_size == 32
        _same_bits(results[rid].value, ref, "q1-hot")


def test_work_steal_counters(data):
    ref_data, port_data = data
    sched = MorselScheduler(n_pools=2, workers_per_pool=1,
                            placement=ThreadPlacement.DENSE,
                            morsel_rows=500, started=False)
    task = sched.build_task(T.LOGICAL_QUERIES["q1"], port_data.tables,
                            TP.ExecutionContext(executor="xla"))
    assert len(task.morsels) == 48
    sched.submit(task)
    homes = [m.home_pool for m in task.morsels]
    assert len(set(homes)) == 1
    sched.start()
    got = task.wait(timeout=120)
    st = sched.stats()
    sched.close()
    assert sum(st.executed_per_pool) == st.morsels_dispatched == 48
    assert st.steals == st.executed_per_pool[1 - homes[0]] >= 1
    _near_reference(got, R.run_query("q1", ref_data, executor="xla"), "q1")


def test_sparse_distributes_whole_plan_tasks(data):
    _, port_data = data
    sched = MorselScheduler(n_pools=2, workers_per_pool=1,
                            placement=ThreadPlacement.SPARSE, steal=False,
                            started=False)
    ctx = TP.ExecutionContext(executor="xla")
    tasks = [sched.build_task(T.LOGICAL_QUERIES["q6"], port_data.tables, ctx)
             for _ in range(6)]
    for t in tasks:
        sched.submit(t)
    assert {t.morsels[0].home_pool for t in tasks} == {0, 1}
    sched.start()
    for t in tasks:
        assert t.wait(timeout=120) is not None
    st = sched.stats()
    sched.close()
    assert all(e == 3 for e in st.executed_per_pool) and st.steals == 0


def test_backpressure_and_deadlines(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    with AnalyticsService(ServiceConfig(queue_depth=2, n_pools=1,
                                        workers_per_pool=1)) as svc:
        r0 = T.submit_query(svc, "q1", port_data, context=ctx)
        r1 = T.submit_query(svc, "q1", port_data, context=ctx,
                            deadline_s=-1.0)
        r2 = T.submit_query(svc, "q1", port_data, context=ctx)
        assert r0 is not None and r1 is not None and r2 is None
        results = svc.drain()
        st = svc.stats()
    assert st.rejected == 1 and st.expired == 1 and st.completed == 1
    assert results[r0].value is not None
    assert results[r1].expired and results[r1].value is None


def test_failed_dispatch_is_isolated(data):
    from repro_torch.analytics.plan import LogicalPlan, scan
    _, port_data = data
    tables = port_data.tables
    bad_plan = LogicalPlan(scan("lineitem").aggregate(
        "no_such_column", 4, s=("sum", "l_quantity")))
    ctx = TP.ExecutionContext(executor="cost")
    ref = T.run_query("q1", port_data, context=ctx)
    with AnalyticsService(ServiceConfig(n_pools=2,
                                        workers_per_pool=2)) as svc:
        good = T.submit_query(svc, "q1", port_data, context=ctx)
        bad = svc.submit(bad_plan, tables, context=ctx)
        results = svc.drain()
        st = svc.stats()
    assert st.completed == 1 and st.failed == 1
    _same_bits(results[good].value, ref, "good-alongside-bad")
    assert results[bad].value is None
    assert results[bad].error and "no_such_column" in results[bad].error
    missing = LogicalPlan(scan("no_such_table").aggregate("x", 2,
                                                          s=("sum", "x")))
    with AnalyticsService(ServiceConfig(n_pools=1, workers_per_pool=1,
                                        morsel_rows=1000)) as svc:
        good = T.submit_query(svc, "q1", port_data, executor="xla")
        bad1 = svc.submit(missing, tables)
        bad2 = svc.submit(missing, tables)
        results = svc.drain()
        st = svc.stats()
    assert st.completed == 1 and st.failed == 2
    assert results[good].value is not None
    for b in (bad1, bad2):
        assert results[b].value is None and results[b].error
    assert st.dispatches == 1 and st.dedup_hits == 0


def test_throughput_smoke(data):
    _, port_data = data
    names = [("q1", "q3", "q6")[i % 3] for i in range(18)]
    ctx = TP.ExecutionContext(executor="cost")
    with AnalyticsService(ServiceConfig(n_pools=2, workers_per_pool=2,
                                        morsel_rows=4000)) as svc:
        rids = [T.submit_query(svc, n, port_data, context=ctx)
                for n in names]
        results = svc.drain()
        st = svc.stats()
    assert st.completed == len(names) == st.admitted
    assert all(results[r].value is not None for r in rids)
    assert st.dispatches == 3 and st.dedup_hits == len(names) - 3
    assert st.qps > 0
    assert st.latency_p99_ms >= st.latency_p50_ms >= 0
    assert st.queue_wait_p99_ms >= st.queue_wait_p50_ms >= 0
    time.sleep(0.1)
    assert svc.stats().qps == pytest.approx(st.qps)


def test_plan_cache_thread_safe_under_concurrency(data):
    _, port_data = data
    TP.clear_plan_cache()
    TP.configure_plan_cache(4)
    names = sorted(T.LOGICAL_QUERIES)
    errors = []
    before = TP.plan_cache_info()
    calls = 6

    def hammer(seed):
        try:
            for i in range(calls):
                T.run_query(names[(seed + i) % len(names)], port_data,
                            executor=("xla", "cost")[(seed + i) % 2])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    info = TP.plan_cache_info()
    assert (info.hits - before.hits) + (info.misses - before.misses) == \
        8 * calls
    assert info.currsize <= 4


def test_service_overload_sheds_and_reports(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    cfg = ServiceConfig(n_pools=1, workers_per_pool=1, queue_depth=8,
                        shed_watermark=4)
    with AnalyticsService(cfg) as svc:
        low = [T.submit_query(svc, "q6", port_data, context=ctx, priority=0,
                              client_id=0) for _ in range(4)]
        high = [T.submit_query(svc, "q1", port_data, context=ctx,
                               priority=2, client_id=1) for _ in range(2)]
        results = svc.drain()
        st = svc.stats()
    assert all(r is not None for r in low + high)
    assert len([r for r in low if results[r].shed]) == 2 and st.shed == 2
    assert all(results[r].value is not None for r in high)
    assert st.completed == 4
    assert st.per_class[0].shed == 2 and st.per_class[2].completed == 2
    assert st.admitted == st.completed + st.failed + st.expired + st.shed


def test_drain_sheds_requests_that_expire_mid_drain(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    T.run_query("q6", port_data, context=ctx)
    faults = ServiceFaultInjector(straggle_pool=(0, 0.3))
    cfg = ServiceConfig(n_pools=1, workers_per_pool=1, max_batch=1,
                        faults=faults, retry=None)
    with AnalyticsService(cfg) as svc:
        r1 = T.submit_query(svc, "q6", port_data, context=ctx)
        r2 = T.submit_query(svc, "q1", port_data, context=ctx,
                            deadline_s=0.1)
        results = svc.drain()
        st = svc.stats()
    assert results[r1].value is not None
    assert results[r2].expired and results[r2].value is None
    assert st.expired == 1 and st.dispatches == 1


def test_close_reports_unjoined_workers(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    faults = ServiceFaultInjector(straggle_pool=(0, 1.0))
    cfg = ServiceConfig(n_pools=1, workers_per_pool=1, faults=faults,
                        retry=None, close_timeout_s=0.1)
    svc = AnalyticsService(cfg)
    rid = T.submit_query(svc, "q6", port_data, context=ctx)
    t = threading.Thread(target=svc.drain, daemon=True)
    t.start()
    time.sleep(0.3)                      # the worker is mid-straggle
    with pytest.raises(WorkerLeakError) as ei:
        svc.close()
    assert "pool0" in str(ei.value) and ei.value.unjoined
    t.join(timeout=30)
    assert not t.is_alive() and rid is not None


def test_always_on_serve_loop(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    serial = {n: T.run_query(n, port_data, context=ctx)
              for n in T.LOGICAL_QUERIES}
    cfg = ServiceConfig(n_pools=2, workers_per_pool=2, min_batch=1,
                        max_batch=8)
    with AnalyticsService(cfg) as svc:
        svc.start()
        assert svc.serving
        first = T.submit_query(svc, "q6", port_data, context=ctx)
        res = svc.result(first, timeout=60.0)
        assert res is not None and res.error is None
        _same_bits(res.value, serial["q6"], "loop/first")
        rids = {n: T.submit_query(svc, n, port_data, context=ctx)
                for n in T.LOGICAL_QUERIES}
        results = svc.drain(timeout=120.0)
        svc.stop()
        assert not svc.serving
        st = svc.stats()
    for name, rid in rids.items():
        _same_bits(results[rid].value, serial[name], f"loop/{name}")
    assert st.completed == len(T.LOGICAL_QUERIES) + 1
    assert st.admitted == st.completed + st.failed + st.expired + st.shed


def test_stop_drains_backlog(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    with AnalyticsService(ServiceConfig(n_pools=1,
                                        workers_per_pool=1)) as svc:
        svc.start()
        rids = [T.submit_query(svc, "q6", port_data, context=ctx)
                for _ in range(6)]
        svc.stop()
        results = svc.take_results()
        st = svc.stats()
    assert sorted(results) == sorted(rids) and st.completed == len(rids)


def test_per_class_slo_attainment(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    with AnalyticsService(ServiceConfig(n_pools=1,
                                        workers_per_pool=1)) as svc:
        met = [T.submit_query(svc, "q6", port_data, context=ctx, priority=2,
                              deadline_s=120.0) for _ in range(3)]
        missed = T.submit_query(svc, "q6", port_data, context=ctx,
                                priority=0, deadline_s=-1.0)
        results = svc.drain()
        st = svc.stats()
    assert all(results[r].value is not None for r in met)
    assert results[missed].expired
    assert st.per_class[2].deadline_total == 3
    assert st.per_class[2].slo_attainment == 1.0
    assert st.per_class[0].deadline_total == 1
    assert st.per_class[0].slo_attainment == 0.0 and st.per_class[0].expired == 1


# ---------------------------------------------------------------------------
# telemetry and tracing
# ---------------------------------------------------------------------------
def test_service_stats_surface_telemetry(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="cost")
    ref = T.run_query("q3", port_data, context=ctx)
    telemetry.registry().clear()
    with telemetry.recording():
        with AnalyticsService(ServiceConfig(n_pools=1,
                                            workers_per_pool=1)) as svc:
            rid = T.submit_query(svc, "q3", port_data, context=ctx)
            got = svc.drain()[rid].value
            st = svc.stats()
    assert st.plans_tracked >= 1 and st.telemetry_executions >= 1
    assert st.replans == 0
    _same_bits(got, ref, "tracked served")
    telemetry.registry().clear()
    with AnalyticsService(ServiceConfig(n_pools=1,
                                        workers_per_pool=1)) as svc:
        T.submit_query(svc, "q6", port_data, context=ctx)
        svc.drain()
        st2 = svc.stats()
    assert st2.plans_tracked == 0 and st2.telemetry_executions == 0


def test_untraced_round_allocates_no_span(data):
    _, port_data = data
    ctx = TP.ExecutionContext(executor="xla")
    before = tracing.tracer().created
    with AnalyticsService(ServiceConfig(n_pools=2, workers_per_pool=2,
                                        morsel_rows=997)) as svc:
        for n in T.LOGICAL_QUERIES:
            T.submit_query(svc, n, port_data, context=ctx)
        results = svc.drain()
    assert all(r.value is not None for r in results.values())
    assert tracing.tracer().created == before
    with tracing.tracing() as tr:
        tr.clear()
        with AnalyticsService(ServiceConfig(n_pools=2, workers_per_pool=1,
                                            morsel_rows=997)) as svc:
            rid = T.submit_query(svc, "q3", port_data, context=ctx)
            res = svc.drain()[rid]
        spans = tr.spans()
        open_left = tr.open_spans()
        tr.clear()
    names = {s.name for s in spans}
    assert {"queue.wait", "dispatch.build", "morsel.run", "merge.partials",
            "result.deliver"} <= names
    assert not open_left
    assert sum(res.phases.values()) <= res.latency_s + 1e-6


def test_tracing_flag_not_in_plan_cache_key(data):
    _, port_data = data
    tables = port_data.tables
    ctx = TP.ExecutionContext(executor="xla")
    q6 = T.LOGICAL_QUERIES["q6"]
    off = TP.compile_plan(q6, tables, ctx).cache_key
    tracing.enable_tracing()
    try:
        h0 = TP.plan_cache_info().hits
        on = TP.compile_plan(q6, tables, ctx)
    finally:
        tracing.disable_tracing()
    assert on.cache_key == off and TP.plan_cache_info().hits == h0 + 1


def test_trace_gate_torch_passes_on_the_cpu():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "trace_gate_torch.py")
    spec = importlib.util.spec_from_file_location("trace_gate_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        assert mod.main(["--device", "cpu"]) == 0
    finally:
        tracing.tracer().clear()
