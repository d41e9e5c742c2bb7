"""The port's execution telemetry and tracing against the reference's:
``tests/test_telemetry.py`` (all but the service test, which waits for the
serving tier) and the unit tests of ``tests/test_tracing.py``.

  * recording: both executors note per-node counters under ``"_stats"``,
    ``CompiledPlan`` strips them and folds them into the StatsRegistry;
    with telemetry disabled no recording site runs at all;
  * explain_analyze: the golden ``tests/fixtures/explain_analyze_q3.txt``
    is matched unchanged on 4 virtual shards (wall token normalised);
  * conservation: the recorded counters equal a numpy recomputation of
    the routing under ``dist_route="modulo"``;
  * re-planning: a mispriced profile picks broadcast, one recorded run
    drifts, the next cache hit flips to partitioned, results unchanged
    (and equal to the reference's);
  * tracing: nesting, the bounded ring, flight dumps, the Chrome trace
    round trip, the golden ``tests/fixtures/trace_timeline.txt``, the flag
    restored and kept out of the plan-cache key, and the planner's
    ``plan.compile`` / ``plan.execute`` spans.

Distributed pieces run on the port's virtual mesh of 4 shards on the CPU;
the reference's counterparts run locally in this process.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from repro.analytics import plan as RL
from repro.analytics import planner as RP
from repro.analytics import tracing as RT
from repro_torch.analytics import physical as PH
from repro_torch.analytics import plan as L
from repro_torch.analytics import planner as TP
from repro_torch.analytics import telemetry, tracing
from repro_torch.analytics import tpch as T
from repro_torch.analytics.tracing import Span, Trace, Tracer
from repro_torch.core.config import PlacementPolicy

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")
N_SHARDS = 4


@pytest.fixture(autouse=True)
def _clean_state():
    TP.set_cost_profile(None)
    telemetry.disable_telemetry()
    telemetry.registry().clear()
    tracing.disable_tracing()
    tracing.tracer().clear()
    yield
    TP.set_cost_profile(None)
    telemetry.disable_telemetry()
    telemetry.registry().clear()
    tracing.disable_tracing()
    tracing.tracer().clear()


def _tensors(tables):
    return {t: {c: torch.from_numpy(a) for c, a in cols.items()}
            for t, cols in tables.items()}


def _local_tables(rng):
    n = 512
    return {"fact": {"k": rng.randint(0, 9, n).astype(np.int32),
                     "v": rng.randn(n).astype(np.float32),
                     "d": rng.randint(0, 100, n).astype(np.int32)}}


def _bits_equal(a, b):
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(
            torch.nan_to_num(a[k], nan=-7.0), torch.nan_to_num(b[k], nan=-7.0))
        for k in a)


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
def test_local_recording_registers_and_strips_stats():
    raw = _local_tables(np.random.RandomState(11))
    tables = _tensors(raw)
    p = L.LogicalPlan(
        L.scan("fact").filter(L.col("d") < 40)
        .aggregate("k", 9, c=("count", "v"), m=("max", "v")), ("c", "m"))
    ctx = TP.ExecutionContext(executor="cost")

    plain = TP.compile_plan(p, tables, ctx)
    ref = plain(tables)
    with telemetry.recording() as reg:
        cp = TP.compile_plan(p, tables, ctx)
        out = cp(tables)

    assert cp.record and not plain.record
    assert cp.cache_key != plain.cache_key     # record flag is in the key
    assert "_stats" not in out and "_stats" not in ref
    assert _bits_equal(out, ref)
    want = RP.execute_plan(RL.LogicalPlan(
        RL.scan("fact").filter(RL.col("d") < 40)
        .aggregate("k", 9, c=("count", "v"), m=("max", "v")), ("c", "m")),
        raw, RP.ExecutionContext(executor="cost"))
    for k in ("c", "m"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))

    ps = reg.get(cp.cache_key)
    assert ps is not None and ps.executions == 1 and len(ps.wall_s) == 1
    alive = raw["fact"]["d"] < 40
    occupied = len(np.unique(raw["fact"]["k"][alive]))
    aggs = [ns for ns in ps.nodes.values() if ns.kind == "aggregate"]
    assert [ns.last["groups_occupied"] for ns in aggs] == [occupied]
    filters = [ns for ns in ps.nodes.values() if ns.kind == "pfilter"]
    assert [(ns.last["alive_in"], ns.last["alive_out"]) for ns in filters] \
        == [(512, int(alive.sum()))]
    assert reg.get(plain.cache_key) is None


def _join_plan(P):
    return P.LogicalPlan(
        P.scan("fact").filter(P.col("d") < 50)
        .join(P.scan("dim"), "fk", "pk", {"dv": "dv"})
        .aggregate("key1", 9, c=("count", "v"), x=("max", "v")), ("c", "x"))


def _join_tables(seed, n=512, d=64):
    rng = np.random.RandomState(seed)
    return {"fact": {"key1": rng.randint(0, 9, n).astype(np.int32),
                     "fk": rng.randint(0, d + 16, n).astype(np.int32),
                     "d": rng.randint(0, 100, n).astype(np.int32),
                     "v": rng.randn(n).astype(np.float32)},
            "dim": {"pk": np.arange(d, dtype=np.int32),
                    "dv": rng.rand(d).astype(np.float32)}}


def test_disabled_telemetry_runs_no_recording_site(monkeypatch):
    """With telemetry off no recording site is reached: ``_note`` and the
    distributed ``_note_parts`` are patched to raise, and local and
    4-shard runs (hash and broadcast Exchanges, a join) pass."""
    def boom(*_a, **_k):
        raise AssertionError("a recording site ran with telemetry off")
    monkeypatch.setattr(TP._LocalExecutor, "_note", boom)
    monkeypatch.setattr(TP._DistributedExecutor, "_note_parts", boom)
    tables = _tensors(_join_tables(3))
    p = _join_plan(L)
    for ctx in (TP.ExecutionContext(executor="cost"),
                TP.ExecutionContext(executor="kernel", join="kernel"),
                TP.ExecutionContext(n_shards=N_SHARDS,
                                    policy=PlacementPolicy.INTERLEAVE,
                                    dist_join="partitioned"),
                TP.ExecutionContext(n_shards=N_SHARDS,
                                    policy=PlacementPolicy.FIRST_TOUCH,
                                    dist_join="broadcast")):
        cp = TP.compile_plan(p, tables, ctx)
        out = cp(tables)
        assert not cp.record and "_stats" not in out
    assert telemetry.registry().summary()["executions"] == 0


def test_explain_analyze_local_annotates():
    tables = _tensors(_local_tables(np.random.RandomState(13)))
    p = L.LogicalPlan(L.scan("fact").aggregate("k", 9, c=("count", "v")),
                      ("c",))
    text = TP.explain_analyze(p, tables)
    assert "[obs groups_occupied=" in text
    assert "est groups_occupied~9" in text
    assert not telemetry.telemetry_enabled()   # flag restored


def test_explain_analyze_matches_golden():
    data = T.generate(scale=0.004, seed=1, device="cpu")
    ctx = TP.ExecutionContext(executor="cost", n_shards=N_SHARDS,
                              policy=PlacementPolicy.INTERLEAVE,
                              dist_join="partitioned")
    got = telemetry.explain_analyze(T.LOGICAL_QUERIES["q3"], data.tables,
                                    ctx).strip("\n")
    # wall time is the one nondeterministic token, as in the reference
    got = re.sub(r"wall=[0-9.]+ms", "wall=<WALL>", got)
    with open(os.path.join(FIXDIR, "explain_analyze_q3.txt")) as f:
        want = f.read().strip("\n")
    assert got == want, f"\n--- got ---\n{got}"


def test_recorded_stats_match_numpy_recomputation():
    n, N, D, G = N_SHARDS, 512, 64, 9
    raw = _join_tables(3, N, D)
    tables = _tensors(raw)
    ctx = TP.ExecutionContext(executor="cost", n_shards=n,
                              policy=PlacementPolicy.INTERLEAVE,
                              dist_join="partitioned", dist_route="modulo")
    with telemetry.recording() as reg:
        cp = TP.compile_plan(_join_plan(L), tables, ctx)
        out = cp(tables)
    ps = reg.get(cp.cache_key)
    assert ps is not None and ps.executions == 1

    fk, d, key1 = raw["fact"]["fk"], raw["fact"]["d"], raw["fact"]["key1"]
    alive = d < 50
    home = np.arange(N) // (N // n)          # block row sharding
    exp = {
        "fk": {"alive_in": int(alive.sum()),
               "moved": int((alive & (fk % n != home)).sum())},
        "pk": {"alive_in": D,
               "moved": int((np.arange(D) % n
                             != np.arange(D) // (D // n)).sum())},
    }
    nodes = ps.node_list()
    seen = set()
    for i, ns in ps.nodes.items():
        node = nodes[i]
        if isinstance(node, PH.Exchange) and node.key in exp:
            assert ns.last["alive_in"] == exp[node.key]["alive_in"]
            assert ns.last["moved"] == exp[node.key]["moved"]
            assert ns.last["overflow"] == 0
            assert ns.last["alive_out"] == ns.last["alive_in"]
            seen.add(node.key)
        if isinstance(node, PH.PJoin) and node.dist is not None:
            assert ns.last["probe_alive"] == int(alive.sum())
            assert ns.last["build_alive"] == D
            assert ns.last["out_alive"] == int((alive & (fk < D)).sum())
        if isinstance(node, PH.PAggregate) and node.key is not None:
            occ = len(np.unique(key1[alive & (fk < D)]))
            assert ns.last["groups_occupied"] == occ
    assert seen == {"fk", "pk"}
    want = RP.execute_plan(_join_plan(RL), raw,
                           RP.ExecutionContext(executor="xla"))
    for k in ("c", "x"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))


def _replan_case(P):
    # Sized so the wire-cost model sits between the two strategies:
    # broadcast = 3 * build_rows = 1728; partitioned = 0.75 * f * (probe +
    # build): f=1.5 -> 1512 (partitioned), mispriced f=3.0 -> 3024
    # (broadcast, the wrong call: the probe filter keeps ~10% of rows)
    rng = np.random.RandomState(7)
    N, D = 768, 576
    raw = {"fact": {"fk": rng.randint(0, D, N).astype(np.int32),
                    "fv": rng.rand(N).astype(np.float32)},
           "dim": {"pk": np.arange(D, dtype=np.int32),
                   "dv": rng.rand(D).astype(np.float32)}}
    j = (P.scan("fact").filter(P.col("fv") < 0.1)
         .join(P.scan("dim"), "fk", "pk", {"dv": "dv"}))
    plan = P.LogicalPlan(j.aggregate("fk", D, c=("count", "fv"),
                                     m=("median", "dv"), x=("max", "fv")),
                         ("c", "m", "x"))
    return raw, plan


def test_mispriced_profile_triggers_replan_flip():
    raw, p = _replan_case(L)
    tables = _tensors(raw)
    ctx = TP.ExecutionContext(executor="cost", n_shards=N_SHARDS,
                              policy=PlacementPolicy.INTERLEAVE)
    cp_good = TP.compile_plan(p, tables, ctx)
    assert "dist=partitioned" in PH.describe(cp_good.physical)
    ref = cp_good(tables)

    TP.set_cost_profile(TP.CostProfile(dist_route_factor=3.0))
    with telemetry.recording() as reg:
        cp1 = TP.compile_plan(p, tables, ctx)
        assert "dist=broadcast" in PH.describe(cp1.physical)
        out1 = cp1(tables)                     # records ~10% probe alive
        assert reg.should_replan(cp1.cache_key)
        assert reg.drift_report()
        cp2 = TP.compile_plan(p, tables, ctx)  # cache HIT -> replan
        assert "dist=partitioned" in PH.describe(cp2.physical)
        out2 = cp2(tables)
    assert cp2.physical == cp_good.physical
    assert reg.summary()["replans"] == 1
    assert _bits_equal(out1, ref) and _bits_equal(out2, ref)
    prof = telemetry.refresh_profile()
    assert prof.source == "telemetry"
    assert prof.dist_route_factor < 3.0 / telemetry.DRIFT_BAND
    rraw, rp = _replan_case(RL)
    want = RP.execute_plan(rp, rraw, RP.ExecutionContext(executor="xla"))
    for k in ("c", "m", "x"):
        np.testing.assert_array_equal(out2[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("n_shards", [None, N_SHARDS])
def test_tracked_queries_give_untracked_bits(n_shards):
    data = T.generate(scale=0.002, seed=3, device="cpu")
    ctx = TP.ExecutionContext(
        executor="kernel" if n_shards is None else "cost", n_shards=n_shards,
        policy=None if n_shards is None else PlacementPolicy.INTERLEAVE)
    for name, plan in T.LOGICAL_QUERIES.items():
        plain = TP.compile_plan(plan, data.tables, ctx)(data.tables)
        with telemetry.recording() as reg:
            cp = TP.compile_plan(plan, data.tables, ctx)
            tracked = cp(data.tables)
        assert _bits_equal(tracked, plain), name
        ps = reg.get(cp.cache_key)
        assert ps.executions == 1 and ps.nodes, name
        assert all(v >= 0 for ns in ps.nodes.values()
                   for v in ns.last.values()), name


def test_stats_read_back_as_ints():
    stats = {2: {"alive_in": torch.tensor(7), "moved": 12},
             0: {"groups_occupied": torch.tensor(3, dtype=torch.int32)}}
    assert TP._read_stats(stats) == {2: {"alive_in": 7, "moved": 12},
                                     0: {"groups_occupied": 3}}
    assert TP._read_stats({1: {"moved": 4}}) == {1: {"moved": 4}}


# ---------------------------------------------------------------------------
# tracing: the tracer's unit behaviour (tests/test_tracing.py)
# ---------------------------------------------------------------------------
def test_begin_end_closes_and_nests():
    tr = Tracer()
    outer = tr.begin("plan.execute", "plan", trace_id=3, pid="plan")
    assert [o.span_id for o in tr.open_spans()] == [outer]
    inner = tr.begin("merge.partials", "scheduler", trace_id=3,
                     parent_id=outer)
    s_in = tr.end(inner, rows=10)
    s_out = tr.end(outer)
    assert tr.open_spans() == []
    assert s_in.parent_id == outer and s_out.span_id == outer
    assert dict(s_in.args)["rows"] == 10
    assert s_out.t0 <= s_in.t0 and s_in.t1 <= s_out.t1
    assert tr.end(outer) is None          # double end is a no-op


def test_ring_is_bounded_and_counts_drops():
    tr = Tracer(max_spans=4)
    for i in range(6):
        tr.instant("morsel.steal", "scheduler", seq=i)
    assert tr.created == 6 and tr.dropped == 2
    assert [dict(s.args)["seq"] for s in tr.spans()] == [2, 3, 4, 5]


def test_flight_dump_snapshots_window_and_open_spans():
    tr = Tracer(flight_window=2)
    for i in range(4):
        tr.add_complete("morsel.run", "scheduler", 10.0 + i, 10.5 + i,
                        seq=i)
    sid = tr.begin("dispatch.build", "service", trace_id=9)
    dump = tr.flight_dump("fault.build_fail", ordinal=1)
    assert dump.reason == "fault.build_fail" and dump.args["ordinal"] == 1
    assert len(dump.spans) == 3
    assert [dict(s.args)["seq"] for s in dump.spans[:2]] == [2, 3]
    assert dict(dump.spans[-1].args)["open"] is True
    assert tr.flight.dumps()[-1] is dump
    tr.end(sid)


def _chrome(mod):
    tr = mod.Tracer()
    tr.add_complete("queue.wait", "queue", 5.0, 5.002, trace_id=1)
    tr.add_complete("morsel.run", "scheduler", 5.002, 5.004, trace_id=1,
                    pid="pool0", tid="pool0-w1")
    tr.instant("morsel.steal", "scheduler", trace_id=1, pid="pool1",
               tid="main")
    doc = tr.trace().to_chrome_trace()
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"][0]
    inst["ts"] = 0.0                       # the instant reads the clock
    return json.loads(json.dumps(doc))


def test_chrome_trace_structure_roundtrips_and_equals_reference():
    doc = _chrome(tracing)
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {e["name"] for e in meta} == {"process_name", "thread_name"}
    assert {e["args"]["name"] for e in meta
            if e["name"] == "process_name"} == {"service", "pool0", "pool1"}
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"queue.wait", "morsel.run"}
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    assert all(e["args"]["trace_id"] == 1 for e in xs)
    inst = [e for e in evs if e["ph"] == "i"]
    assert len(inst) == 1 and inst[0]["s"] == "t"
    assert doc == _chrome(RT)


def _golden_spans(mod):
    return [
        mod.Span("queue.wait", "queue", 100.000, 0.004, trace_id=7,
                 pid="service", tid="main", args=(("cls", 1),)),
        mod.Span("batch.group", "batcher", 100.004, 0.001, pid="service",
                 tid="main", args=(("requests", 2),)),
        mod.Span("dispatch.build", "service", 100.005, 0.006, trace_id=7,
                 pid="service", tid="main"),
        mod.Span("morsel.run", "scheduler", 100.011, 0.010, trace_id=7,
                 pid="pool0", tid="pool0-w0", args=(("seq", 0),)),
        mod.Span("morsel.steal", "scheduler", 100.013, 0.0, trace_id=7,
                 pid="pool1", tid="pool1-w0", args=(("victim", 0),)),
        mod.Span("morsel.run", "scheduler", 100.013, 0.009, trace_id=7,
                 pid="pool1", tid="pool1-w0", args=(("seq", 1),)),
        mod.Span("merge.partials", "scheduler", 100.022, 0.002, trace_id=7,
                 pid="service", tid="drain"),
        mod.Span("result.deliver", "service", 100.024, 0.001, trace_id=7,
                 pid="service", tid="drain"),
    ]


def test_timeline_matches_golden():
    got = Trace(_golden_spans(tracing)).render_timeline(width=40)
    with open(os.path.join(FIXDIR, "trace_timeline.txt")) as f:
        want = f.read().strip("\n")
    assert got == want, f"timeline drifted\n--- got ---\n{got}"
    assert got == RT.Trace(_golden_spans(RT)).render_timeline(width=40)
    assert Trace([]).render_timeline() == "trace: empty"


def test_tracing_context_manager_restores_flag():
    assert not tracing.tracing_enabled()
    with tracing.tracing() as tr:
        assert tracing.tracing_enabled() and tr is tracing.tracer()
    assert not tracing.tracing_enabled()


# ---------------------------------------------------------------------------
# tracing: the planner's spans and the cache-key contract
# ---------------------------------------------------------------------------
def test_tracing_flag_not_in_plan_cache_key():
    data = T.generate(scale=0.002, seed=1, device="cpu")
    plan = T.LOGICAL_QUERIES["q6"]
    ctx = TP.ExecutionContext(executor="xla")
    off = TP.compile_plan(plan, data.tables, ctx)
    h0 = TP.plan_cache_info().hits
    with tracing.tracing():
        on = TP.compile_plan(plan, data.tables, ctx)
    assert on.cache_key == off.cache_key
    assert TP.plan_cache_info().hits == h0 + 1     # a hit, not a re-lower


def test_plan_spans_compile_and_execute_close():
    data = T.generate(scale=0.002, seed=2, device="cpu")
    ctx = TP.ExecutionContext(executor="cost", n_shards=N_SHARDS,
                              policy=PlacementPolicy.FIRST_TOUCH)
    TP.clear_plan_cache()
    before = tracing.tracer().created
    T.run_query("q1", data, context=ctx)           # untraced: no span
    assert tracing.tracer().created == before
    TP.clear_plan_cache()
    with tracing.tracing() as tr:
        with telemetry.recording():
            T.run_query("q3", data, context=ctx)
        T.run_query("q3", data, context=ctx)       # a second cache entry
        T.run_query("q3", data, context=ctx)       # a hit: execute only
        every, open_left = tr.spans(), tr.open_spans()
    assert open_left == []
    # the operators' spans of each walk (op, sync) come beside the plan's
    spans = [s for s in every if s.cat == "plan"]
    assert {s.cat for s in every} - {"plan"} <= {"op", "sync"}
    names = [s.name for s in spans]
    assert names == ["plan.compile", "plan.execute", "plan.compile",
                     "plan.execute", "plan.execute"]
    assert [dict(s.args).get("recorded") for s in spans
            if s.name == "plan.execute"] == [True, False, False]
    assert all(s.pid == "plan" and s.dur >= 0 for s in spans)
