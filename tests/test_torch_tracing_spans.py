"""The port's tracer inside W1-W4: ``span``, ``scope`` and ``drain`` of
``analytics/tracing.py``, the operator, phase and sync spans of
``aggregate.py`` and ``join.py`` (and the helpers they share with the
planner), and a served query's request id reaching them. CPU tensors at
tiny sizes; the card's checks are in ``tests/test_torch_cuda_spans.py``.
"""
import threading

import pytest
import torch

from repro_torch.analytics import aggregate, join, planner, tpch, tracing
from repro_torch.analytics.service import AnalyticsService, ServiceConfig


@pytest.fixture(autouse=True)
def _clean_tracer():
    tracing.disable_tracing()
    tracing.tracer().clear()
    yield
    tracing.disable_tracing()
    tracing.tracer().clear()


def _w_inputs():
    g = torch.Generator().manual_seed(5)
    keys = torch.randint(0, 3000, (40_000,), generator=g)
    vals = torch.rand(40_000, generator=g)
    build = torch.randperm(8000, generator=g)[:2000].to(torch.int32)
    bvals = torch.rand(2000, generator=g)
    probe = build[torch.randint(0, 2000, (30_000,), generator=g)]
    return keys, vals, build, bvals, probe


def _run_w(keys, vals, build, bvals, probe):
    """W1-W4 at tiny sizes: every result, in a fixed order."""
    out = [aggregate.median_direct(keys, vals, 4096)]
    out += list(aggregate.count_partitioned(keys, 4096, n_partitions=16))
    out += list(join.hash_join(build, bvals, probe, n_partitions=16))
    for kind in ("radix", "sorted", "hash"):
        out += list(join.index_join(build, bvals, probe, kind))
    return out


# ---------------------------------------------------------------------------
# span / scope / current
# ---------------------------------------------------------------------------
def test_spans_nest_and_inherit_the_scope_trace_id():
    with tracing.tracing() as tr:
        assert tracing.current() is None
        with tracing.scope(11):
            with tracing.span("outer", "op", pid="lane", rows=3) as outer:
                assert tracing.current() is outer
                with tracing.span("inner", "sync") as inner:
                    assert tracing.current().name == "inner"
                with tracing.scope(12):
                    assert tracing.current().span_id == outer.span_id
                    with tracing.span("rescoped", "op"):
                        pass
            with tracing.span("sibling", "op"):
                pass
        with tracing.span("unscoped", "op"):
            pass
        assert tracing.current() is None
        spans = {s.name: s for s in tr.drain()}
    assert spans["outer"].parent_id == -1 and spans["outer"].trace_id == 11
    assert dict(spans["outer"].args) == {"rows": 3}
    assert spans["inner"].parent_id == outer.span_id == spans["outer"].span_id
    assert spans["inner"].span_id == inner.span_id
    assert spans["inner"].trace_id == 11 and spans["inner"].pid == "lane"
    assert spans["rescoped"].parent_id == outer.span_id
    assert spans["rescoped"].trace_id == 12
    assert spans["sibling"].parent_id == -1 and spans["sibling"].trace_id == 11
    assert spans["sibling"].pid == "op"
    assert spans["unscoped"].trace_id == -1
    o, i = spans["outer"], spans["inner"]
    assert o.t0 <= i.t0 and i.t1 <= o.t1


def test_a_scope_opened_in_a_thread_reaches_its_spans_alone():
    seen = {}

    def worker():
        seen["before"] = tracing.current()
        with tracing.scope(7):
            with tracing.span("morsel.op", "op"):
                with tracing.span("morsel.sync", "sync"):
                    pass

    with tracing.tracing() as tr:
        with tracing.scope(3):
            with tracing.span("main", "op"):
                t = threading.Thread(target=worker, name="w-1")
                t.start()
                t.join(timeout=10)
        assert not t.is_alive()
        spans = {s.name: s for s in tr.drain()}
    assert seen["before"] is None          # nothing leaks into the thread
    op, sync = spans["morsel.op"], spans["morsel.sync"]
    assert op.trace_id == sync.trace_id == 7
    assert op.parent_id == -1 and sync.parent_id == op.span_id
    assert op.pid == sync.pid == "op" and op.tid == "w-1"
    assert spans["main"].trace_id == 3 and spans["main"].tid != "w-1"


def test_off_span_and_scope_are_one_shared_object():
    tr = tracing.tracer()
    before = tr.created
    a = tracing.span("x", "op", k=1)
    b = tracing.scope(5)
    assert a is b
    with a as got:
        assert got is None and tracing.current() is None
    assert tr.created == before and tr.spans() == []


def test_a_span_is_recorded_when_its_block_raises():
    with tracing.tracing() as tr:
        with pytest.raises(ValueError):
            with tracing.span("fails", "op"):
                raise ValueError("boom")
        assert tracing.current() is None
        assert [s.name for s in tr.drain()] == ["fails"]


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------
def test_drain_loses_nothing_and_dropped_counts_an_undrained_overflow():
    tr = tracing.tracer()
    got = []
    with tracing.tracing():
        for i in range(20_000):
            with tracing.span("s", "op", i=i):
                pass
            if (i + 1) % 1000 == 0:
                got += tr.drain()
    assert [dict(s.args)["i"] for s in got] == list(range(20_000))
    assert tr.dropped == 0 and tr.drain() == []
    small = tracing.Tracer(max_spans=1000)
    for i in range(1500):
        small.add_complete("s", "op", 0.0, 1.0, i=i)
    assert small.dropped == 500 and small.created == 1500
    kept = small.drain()
    assert [dict(s.args)["i"] for s in kept] == list(range(500, 1500))
    assert small.drain() == [] and small.dropped == 500


def test_the_span_clock_is_now():
    with tracing.tracing() as tr:
        t0 = tracing.now()
        with tracing.span("s", "op"):
            pass
        t1 = tracing.now()
        (s,) = tr.drain()
    assert t0 <= s.t0 <= s.t1 <= t1


# ---------------------------------------------------------------------------
# W1-W4
# ---------------------------------------------------------------------------
def test_w1_w4_untraced_allocate_no_span_and_give_the_traced_bits():
    args = _w_inputs()
    before = tracing.tracer().created
    off = _run_w(*args)
    assert tracing.tracer().created == before
    with tracing.tracing() as tr:
        on = _run_w(*args)
        assert tr.drain()
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert torch.equal(torch.nan_to_num(a, nan=-7.0),
                           torch.nan_to_num(b, nan=-7.0))


# (op span, its phases in order, {sync site: reads})
W_SPANS = {
    "median_direct": (["median.sort", "median.counts", "median.select"],
                      {"sync:segment_sum.longest": 1}),
    "count_partitioned": (["count.partition", "count.aggregate"],
                          {"sync:count.bincount": 2,
                           "sync:pad_partitions.pad_key": 1}),
    "hash_join": (["hash_join.layout", "hash_join.layout", "hash_join.probe"],
                  {"sync:hash_join.bincount": 4,
                   "sync:pad_partitions.pad_key": 2}),
    "index_join.radix": (["index.build", "index.probe"],
                         {"sync:radix_index.bincount": 2}),
    "index_join.sorted": (["index.build", "index.probe"], {}),
    "index_join.hash": (["index.build", "index.probe"], {}),
}


def test_w1_w4_traced_give_their_op_phase_and_sync_spans_under_one_scope():
    with tracing.tracing() as tr:
        with tracing.scope(41):
            _run_w(*_w_inputs())
        spans = tr.drain()
    assert {s.trace_id for s in spans} == {41}
    by_id = {s.span_id: s for s in spans}
    ops = sorted((s for s in spans if s.parent_id == -1), key=lambda s: s.t0)
    names = [s.name + (f".{dict(s.args)['kind']}" if s.name == "index_join"
                       else "") for s in ops]
    assert names == list(W_SPANS)
    assert all(s.cat == "op" for s in ops)

    def root(s):
        while s.parent_id != -1:
            s = by_id[s.parent_id]
        return s

    for op, name in zip(ops, names):
        phases, syncs = W_SPANS[name]
        children = sorted((s for s in spans if s.parent_id == op.span_id),
                          key=lambda s: s.t0)
        assert [c.name for c in children] == phases, name
        assert all(c.cat == "op" and op.t0 <= c.t0 and c.t1 <= op.t1
                   for c in children)
        reads = {}
        for s in spans:
            if s.cat == "sync" and root(s) is op:
                assert s.name.startswith("sync:")
                reads[s.name] = reads.get(s.name, 0) + dict(s.args).get(
                    "syncs", 1)
        assert reads == syncs, name
    layouts = [dict(s.args)["side"] for s in spans
               if s.name == "hash_join.layout"]
    assert sorted(layouts) == ["build", "probe"]
    assert all(dict(s.args)["kind"] == dict(by_id[s.parent_id].args)["kind"]
               for s in spans if s.name.startswith("index."))


def test_the_plan_walk_nests_the_helpers_spans_under_plan_execute():
    data = tpch.generate(scale=0.002, seed=3, device="cpu")
    ctx = planner.ExecutionContext(executor="xla")
    plan = tpch.LOGICAL_QUERIES["qm"]
    planner.compile_plan(plan, data.tables, ctx)
    with tracing.tracing() as tr:
        planner.compile_plan(plan, data.tables, ctx)(data.tables)
        spans = tr.drain()
    (ex,) = [s for s in spans if s.name == "plan.execute"]
    phases = [s for s in spans if s.name.startswith("median.")]
    assert phases and all(s.parent_id == ex.span_id for s in phases)
    assert all(s.pid == "plan" for s in phases)


def test_a_served_query_carries_its_request_id_to_the_operators():
    data = tpch.generate(scale=0.002, seed=4, device="cpu")
    ctx = planner.ExecutionContext(executor="xla")
    before = tracing.tracer().created
    with AnalyticsService(ServiceConfig(n_pools=1,
                                        workers_per_pool=1)) as svc:
        tpch.submit_query(svc, "q6", data, context=ctx)
        svc.drain()
    assert tracing.tracer().created == before
    with tracing.tracing() as tr:
        with AnalyticsService(ServiceConfig(n_pools=1,
                                            workers_per_pool=1)) as svc:
            first = tpch.submit_query(svc, "q6", data, context=ctx)
            rid = tpch.submit_query(svc, "qm", data, context=ctx)
            results = svc.drain()
        spans = tr.drain()
    assert results[rid].error is None and rid != first
    assert not tr.open_spans()
    ops = [s for s in spans if s.cat in ("op", "sync")]
    (ex,) = [s for s in spans if s.name == "plan.execute"
             and s.trace_id == rid]
    mine = [s for s in ops if s.trace_id == rid]
    assert {"median.sort", "median.counts", "median.select"} <= {
        s.name for s in mine}
    assert all(s.trace_id in (first, rid) for s in ops)
    assert all(s.tid == ex.tid == "pool0-w0" for s in mine)
    assert all(s.pid == "plan" for s in mine + [ex])


def test_the_serving_spans_are_block_spans_under_the_request_id():
    data = tpch.generate(scale=0.002, seed=4, device="cpu")
    ctx = planner.ExecutionContext(executor="xla")
    planner.clear_plan_cache()
    with tracing.tracing() as tr:
        with AnalyticsService(ServiceConfig(n_pools=1,
                                            workers_per_pool=1)) as svc:
            rid = tpch.submit_query(svc, "qm", data, context=ctx)
            results = svc.drain()
        spans = tr.drain()
    assert results[rid].error is None and not tr.open_spans()
    by_id = {s.span_id: s for s in spans}
    (build,) = [s for s in spans if s.name == "dispatch.build"]
    assert build.trace_id == rid and build.pid == "service"
    assert dict(build.args)["morsels"] >= 1
    (compiled,) = [s for s in spans if s.name == "plan.compile"]
    assert compiled.parent_id == build.span_id and compiled.trace_id == rid
    (group,) = [s for s in spans if s.name == "batch.group"]
    assert dict(group.args) == {"requests": 1, "batches": 1}
    (ex,) = [s for s in spans if s.name == "plan.execute"]
    run = by_id[ex.parent_id]
    assert run.name == "morsel.run" and run.trace_id == ex.trace_id == rid
    assert run.pid == "pool0" and run.tid == ex.tid


def test_note_and_an_error_land_on_the_open_span():
    before = tracing.tracer().created
    tracing.note(k=1)                       # off: nothing to note on
    assert tracing.tracer().created == before
    with tracing.tracing() as tr:
        with tracing.span("a", "service", n=1):
            tracing.note(morsels=3)
            with tracing.scope(2):
                tracing.note(k=1)           # through the scope, onto "a"
        with pytest.raises(KeyError):
            with tracing.span("b", "service"):
                raise KeyError("x")
        spans = {s.name: s for s in tr.drain()}
    assert dict(spans["a"].args) == {"n": 1, "morsels": 3, "k": 1}
    assert dict(spans["b"].args) == {"error": "KeyError"}


def test_a_flight_dump_keeps_the_serving_spans_and_not_the_operators():
    with tracing.tracing() as tr:
        tr.add_complete("queue.wait", "queue", 1.0, 2.0, trace_id=5)
        with tracing.scope(5), tracing.span("dispatch.build", "service",
                                            pid="service"):
            for _ in range(300):
                with tracing.span("s", "op"):
                    pass
            with tracing.span("sync:x", "sync"):
                dump = tr.flight_dump("fault.build_fail", trace_id=5)
    assert [(s.name, s.trace_id) for s in dump.spans] == [
        ("queue.wait", 5), ("dispatch.build", 5)]
    assert dict(dump.spans[1].args) == {"open": True}


def test_operator_spans_do_not_evict_the_serving_spans():
    with tracing.tracing() as tr:
        tr.add_complete("queue.wait", "queue", 1.0, 2.0, trace_id=5)
        for _ in range(9000):
            with tracing.span("s", "op"):
                pass
        spans = tr.spans()
    assert [s.name for s in spans if s.cat == "queue"] == ["queue.wait"]
    assert tr.dropped == 9000 - 8192
    assert len(spans) == 1 + 8192
