"""The port against the reference on randomized plans: the parity fuzz
grids of ``tests/test_plan_fuzz.py`` and the strategy grid of
``tests/test_dist_plans.py``, run through the port's planner.

Plans come from ``tests/_torch_plan_gen.py`` (the reference generator over
the port's plan IR: the same seeds give the same plans, checked below).
Every port result is compared with the reference's LOCAL ``xla`` result on
the same numpy tables, computed in this process, at ``_check_parity``'s
tolerances (``tests/test_plan_fuzz.py``): counts, order statistics and
TopK indices bit for bit, sums and averages within atol 1e-2, rtol 1e-4,
and ``_overflow`` 0 everywhere.

  * local grid: the port's xla, kernel and cost executors and the
    deliberately overflowing kernel-join context (its residual re-probe
    must repair to zero overflow), each also run under telemetry: the
    tracked run returns the same result set (``"_stats"`` never leaks) and
    the grouped aggregate's occupied-group count is exact;
  * distributed grid: FIRST_TOUCH, INTERLEAVE, INTERLEAVE without
    push-down, and the partitioned join with the Exchange layout chosen,
    forced to argsort and forced to radix, on 4 virtual shards with the
    capacity factor fuzzed per seed; tracked re-runs whose counters obey
    the reference's conservation rules; both distributed TopK lowerings;
    and the guard plan whose filter kills every row;
  * strategy grid: q3, q5 and q18 at scale 0.004 under FIRST_TOUCH and
    INTERLEAVE x {broadcast, partitioned} joins on 8 virtual shards.
"""
import numpy as np
import pytest
import torch

import _plan_gen as RG
import _torch_plan_gen as TG
from repro.analytics import planner as RP
from repro.analytics import tpch as R
from repro_torch.analytics import physical as PH
from repro_torch.analytics import plan as L
from repro_torch.analytics import planner as TP
from repro_torch.analytics import telemetry
from repro_torch.analytics import tpch as T
from repro_torch.core.config import PlacementPolicy

LOCAL_SEEDS = range(16)
LOCAL_CHUNKS = 4
DIST_SEEDS = range(8)
N_SHARDS = 4


@pytest.fixture(autouse=True)
def _clean_state():
    TP.set_cost_profile(None)
    telemetry.disable_telemetry()
    telemetry.registry().clear()
    yield
    telemetry.disable_telemetry()
    telemetry.registry().clear()


@pytest.fixture(scope="module")
def tables():
    return {t: {c: torch.from_numpy(a) for c, a in cols.items()}
            for t, cols in TG.make_tables().items()}


def _reference(seed):
    """The reference's local xla result of plan ``seed``, as numpy."""
    out = RP.execute_plan(RG.make_plan(seed), RG.make_tables(),
                          RP.ExecutionContext(executor="xla"))
    return {k: np.asarray(v) for k, v in out.items()}


def _check_parity(got, ref, ops, tag):
    assert set(got) == set(ref), tag
    for k in ref:
        a, b = got[k].numpy(), ref[k]
        if k == "_overflow":
            assert int(a) == 0 and int(b) == 0, (tag, k, int(a))
        elif TG.exact_output(k, ops):
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}/{k}")
        else:
            np.testing.assert_allclose(a, b, atol=1e-2, rtol=1e-4,
                                       equal_nan=True, err_msg=f"{tag}/{k}")


def _tracked(plan, tables, ctx):
    """One run under telemetry: (result, the plan's registry entry)."""
    with telemetry.recording() as reg:
        cp = TP.compile_plan(plan, tables, ctx)
        out = cp(tables)
    ps = reg.get(cp.cache_key)
    assert cp.record and ps is not None and ps.executions == 1
    return out, ps


def test_generator_gives_the_reference_plans():
    for seed in list(LOCAL_SEEDS) + [1000, 4242]:
        assert repr(TG.make_plan(seed)) == repr(RG.make_plan(seed)), seed
    for t, cols in RG.make_tables().items():
        for c, a in cols.items():
            assert np.array_equal(TG.make_tables()[t][c], a), (t, c)


# ---------------------------------------------------------------------------
# local grid
# ---------------------------------------------------------------------------
def _run_local_seed(seed, tables):
    plan = TG.make_plan(seed)
    L.validate(plan)
    ops = TG.plan_agg_ops(plan)
    ref = _reference(seed)
    contexts = {e: TP.ExecutionContext(executor=e)
                for e in ("xla", "kernel", "cost")}
    if TG.plan_has_join(plan):
        # deliberate kernel-join capacity overflow: the residual sorted
        # re-probe must repair every miss and report zero overflow
        contexts["kernel-join-residual"] = TP.ExecutionContext(
            executor="cost", join="kernel", n_partitions=2,
            capacity_factor=0.25)
    grouped = (not any(isinstance(n, L.TopK) for n in L.walk(plan.root))
               and TG._root_aggregate(plan).key is not None)
    occ_ref = int(np.count_nonzero(ref["_count"] > 0)) if grouped else None
    for tag, ctx in contexts.items():
        _check_parity(TP.execute_plan(plan, tables, ctx), ref, ops,
                      f"seed={seed}/{tag}")
        if tag == "xla":
            continue
        tracked, ps = _tracked(plan, tables, ctx)
        _check_parity(tracked, ref, ops, f"seed={seed}/{tag}+telemetry")
        assert all(v >= 0 for ns in ps.nodes.values()
                   for v in ns.last.values()), seed
        if grouped:
            occupied = [ns.last["groups_occupied"]
                        for ns in ps.nodes.values()
                        if "groups_occupied" in ns.last]
            assert occ_ref in occupied, (seed, tag, occ_ref, occupied)


@pytest.mark.parametrize("chunk", range(LOCAL_CHUNKS))
def test_fuzz_local_executor_parity(chunk, tables):
    for seed in LOCAL_SEEDS:
        if seed % LOCAL_CHUNKS == chunk:
            _run_local_seed(seed, tables)


# ---------------------------------------------------------------------------
# distributed grid (4 virtual shards)
# ---------------------------------------------------------------------------
def _conservation(ps, out, tag):
    """The reference fuzz's invariants over one recorded execution:
    routing conserves alive rows up to its surfaced overflow, a broadcast
    moves exactly alive * (n - 1) rows, and every overflow counter is the
    plan's ``_overflow``. Returns (sorted join counts, sorted occupied
    groups)."""
    nodes = ps.node_list()
    ovf, joins, aggs = 0, [], []
    for i, ns in sorted(ps.nodes.items()):
        node, last = nodes[i], ns.last
        assert all(v >= 0 for v in last.values()), (tag, last)
        if isinstance(node, PH.Exchange):
            o = last.get("overflow", 0)
            ovf += o
            if node.kind == "hash":
                assert last["alive_out"] == last["alive_in"] - o, (tag, last)
                assert last["moved"] <= last["alive_in"], (tag, last)
            else:
                assert last["moved"] == last["alive_in"] * (N_SHARDS - 1), \
                    (tag, last)
        elif isinstance(node, PH.Compact):
            o = last.get("overflow", 0)
            ovf += o
            assert last["alive_out"] == last["alive_in"] - o, (tag, last)
        elif isinstance(node, PH.PJoin) and node.dist is not None:
            assert last["out_alive"] <= last["probe_alive"], (tag, last)
            joins.append((last["probe_alive"], last["build_alive"],
                          last["out_alive"]))
        elif isinstance(node, PH.PAggregate) and node.key is not None:
            assert last["groups_occupied"] <= node.n_groups, (tag, last)
            aggs.append(last["groups_occupied"])
    assert ovf == int(out["_overflow"]) == 0, (tag, ovf)
    return sorted(joins), sorted(aggs)


def _dist_ctx(cf, **kw):
    kw.setdefault("policy", PlacementPolicy.INTERLEAVE)
    return TP.ExecutionContext(executor="xla", n_shards=N_SHARDS,
                               capacity_factor=cf, **kw)


@pytest.mark.parametrize("seed", DIST_SEEDS)
def test_fuzz_distributed_policy_parity(seed, tables):
    plan = TG.make_plan(seed)
    ops = TG.plan_agg_ops(plan)
    ref = _reference(seed)
    cf = TG.context_capacity_factor(seed)
    has_topk = any(isinstance(n, L.TopK) for n in L.walk(plan.root))
    contexts = [("ft", _dist_ctx(cf, policy=PlacementPolicy.FIRST_TOUCH)),
                ("il", _dist_ctx(cf)),
                ("il-nopd", _dist_ctx(cf, agg_pushdown=False))]
    if TG.plan_has_join(plan):
        contexts.append(("il-part", _dist_ctx(cf, dist_join="partitioned")))
        for impl in ("argsort", "radix"):
            contexts.append((f"il-part-{impl}",
                             _dist_ctx(cf, dist_join="partitioned",
                                       exchange_impl=impl)))
    recorded = []
    for tag, ctx in contexts:
        tag = f"seed={seed}/{tag}"
        _check_parity(TP.execute_plan(plan, tables, ctx), ref, ops, tag)
        if tag.endswith(("/il", "-argsort", "-radix")):
            out, ps = _tracked(plan, tables, ctx)
            _check_parity(out, ref, ops, tag + "+rec")
            recorded.append(_conservation(ps, out, tag))
    # occupied groups are relational facts, independent of the lowering;
    # join counts agree where the lowered shapes do (the two forced
    # layouts differ only in the routing pass)
    for other in recorded[1:]:
        assert other[1] == recorded[0][1], (seed, recorded)
    if len(recorded) == 3:
        assert recorded[1] == recorded[2], (seed, recorded)
    if not has_topk and TG._root_aggregate(plan).key is not None:
        occ = int(np.count_nonzero(ref["_count"] > 0))
        assert occ in recorded[0][1], (seed, occ, recorded[0])
    if has_topk:
        k = plan.root.k
        for mode in ("replicated", "candidates"):
            _check_parity(TP.execute_plan(plan, tables,
                                          _dist_ctx(cf, dist_topk=mode)),
                          ref, ops, f"seed={seed}/tk-{mode}")
        mode = TG.context_dist_topk(seed)
        out, ps = _tracked(plan, tables, _dist_ctx(cf, dist_topk=mode))
        _check_parity(out, ref, ops, f"seed={seed}/tk-{mode}+rec")
        nodes = ps.node_list()
        topks = [n for n in nodes if isinstance(n, PH.PTopK)]
        assert len(topks) == 1 and topks[0].dist == mode, (seed, mode)
        if mode == "candidates":
            ex = topks[0].child
            assert isinstance(ex, PH.Exchange) and ex.kind == "gather", ex
            assert ex.moved_rows == k * (N_SHARDS - 1), (seed, ex)
            ns = [s for i, s in ps.nodes.items() if nodes[i] is ex][0]
            assert ns.last["alive_in"] == k * N_SHARDS, (seed, ns.last)
            assert ns.last["moved"] == k * (N_SHARDS - 1) * N_SHARDS, \
                (seed, ns.last)
        else:
            assert not isinstance(topks[0].child, PH.Exchange), seed


def test_fuzz_distributed_dead_filter_guard(tables):
    """A predicate no fact row satisfies kills every row on every shard
    before the partitioned join routes them: both Exchange layouts must
    give the all-empty answer with zero overflow, tracked or not."""
    def dead(P):
        return P.LogicalPlan(
            P.scan("fact").filter(P.col("d") < 0.0)
            .join(P.scan("dim"), "fk", "pk", {"_dv": "dv"})
            .aggregate("key1", TG.G1, s=("sum", "v1"), c=("count", "v1")),
            None)
    from repro.analytics import plan as RL
    ref = {k: np.asarray(v) for k, v in RP.execute_plan(
        dead(RL), RG.make_tables(), RP.ExecutionContext(executor="xla")
    ).items()}
    assert int(ref["c"].sum()) == 0
    plan = dead(L)
    ops = TG.plan_agg_ops(plan)
    for impl in ("argsort", "radix"):
        ctx = TP.ExecutionContext(executor="xla", n_shards=N_SHARDS,
                                  policy=PlacementPolicy.INTERLEAVE,
                                  dist_join="partitioned",
                                  exchange_impl=impl)
        _check_parity(TP.execute_plan(plan, tables, ctx), ref, ops,
                      f"dead/{impl}")
        # recorded: every shard makes the same collectives though none
        # has an alive row, and the counters say so
        out, ps = _tracked(plan, tables, ctx)
        _check_parity(out, ref, ops, f"dead/{impl}+rec")
        joins, aggs = _conservation(ps, out, f"dead/{impl}")
        assert joins == [(0, TG.D, 0)] and aggs == [0], (joins, aggs)


# ---------------------------------------------------------------------------
# strategy grid: partitioned == broadcast == local (8 virtual shards)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tpch_data():
    ref = R.generate(scale=0.004, seed=1)
    return ref, T.from_numpy(ref.tables, ref.scale, device="cpu")


@pytest.mark.parametrize("name", ["q3", "q5", "q18"])
def test_partitioned_equals_broadcast_equals_local(tpch_data, name):
    ref_data, port_data = tpch_data
    ref = {k: np.asarray(v) for k, v in
           R.run_query(name, ref_data, executor="xla").items()}
    for pol in (PlacementPolicy.FIRST_TOUCH, PlacementPolicy.INTERLEAVE):
        for dj in ("broadcast", "partitioned"):
            ctx = TP.ExecutionContext(executor="xla", n_shards=8, policy=pol,
                                      capacity_factor=4.0, dist_join=dj)
            got = T.run_query(name, port_data, context=ctx)
            assert set(got) == set(ref), (name, pol, dj)
            for k in ref:
                if k == "_overflow":
                    assert int(got[k]) == 0, (name, pol, dj)
                    continue
                np.testing.assert_allclose(
                    got[k].numpy(), ref[k], atol=1e-2, rtol=1e-4,
                    err_msg=f"{name}/{pol}/{dj}/{k}")
