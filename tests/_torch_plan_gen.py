"""Random logical-plan generator for the port's parity fuzz harness.

``tests/_plan_gen.py`` over ``repro_torch.analytics.plan``: the same
seeds give the same plans (their reprs are equal, which
``tests/test_torch_plan_fuzz.py`` checks), built from the port's own plan
IR so that the port's planner can lower them. See ``_plan_gen.py`` for
what the plans cover. The morsel-forced grid's helpers are left out: the
serving tier is not ported yet.
"""
import numpy as np

from repro_torch.analytics import plan as L

N_ROWS = 768          # divisible by the 4-device fuzz mesh
G1 = 13               # fact group-key domain (not mesh-divisible: exercises
                      # the padded INTERLEAVE slot math)
D = 48                # dimension rows (dense PK)
DK = 7                # dimension group-key domain

AGG_OPS = ("sum", "avg", "count", "max", "min", "median", "quantile:0.25",
           "quantile:0.9", "distinct")

# tight-but-safe routing capacities for the 4-shard distributed grid: the
# generated keys are uniform, so per-owner shares stay well under the
# 128-row capacity tile even at 1.5 (overflow across this sweep must be 0)
DIST_CAPACITY_FACTORS = (1.5, 2.5, 4.0)


def context_capacity_factor(seed: int) -> float:
    """Deterministic per-seed capacity factor for the distributed grid."""
    return DIST_CAPACITY_FACTORS[seed % len(DIST_CAPACITY_FACTORS)]


DIST_TOPK_MODES = ("replicated", "candidates")


def context_dist_topk(seed: int) -> str:
    """Deterministic per-seed FORCED distributed-TopK lowering: the fuzz
    runs BOTH forced modes for parity and uses this to alternate which
    one gets the telemetry-tracked wire-accounting pass."""
    return DIST_TOPK_MODES[seed % len(DIST_TOPK_MODES)]


def make_tables(seed: int = 0):
    """Deterministic base tables: a fact table and a joinable dimension.

    ~1 in 7 fact foreign keys miss the dimension (exercises the join-miss
    mask), and values span negative/positive so min/max/median see both
    signs."""
    rng = np.random.RandomState(1_000_003 + seed)
    fact = {
        "key1": rng.randint(0, G1, N_ROWS).astype(np.int32),
        "fk": rng.randint(0, D + D // 6, N_ROWS).astype(np.int32),
        "v1": (rng.randn(N_ROWS) * 10).astype(np.float32),
        "v2": rng.rand(N_ROWS).astype(np.float32),
        "d": rng.randint(0, 100, N_ROWS).astype(np.int32),
    }
    dim = {
        "pk": np.arange(D, dtype=np.int32),
        "dk": rng.randint(0, DK, D).astype(np.int32),
        "dv": rng.rand(D).astype(np.float32),
    }
    return {"fact": fact, "dim": dim}


def make_plan(seed: int) -> L.LogicalPlan:
    """One deterministic random plan per seed (outputs=None: everything)."""
    rng = np.random.RandomState(seed)
    node = L.scan("fact")
    projected = False
    if rng.rand() < 0.7:
        thresh = float(rng.randint(10, 90))
        preds = (L.col("d") < thresh, L.col("d") >= thresh,
                 L.col("v1") > 0.0,
                 (L.col("d") < thresh) & (L.col("v2") > 0.25))
        node = node.filter(preds[rng.randint(len(preds))])
    if rng.rand() < 0.6:
        exprs = (L.col("v1") * (1 - L.col("v2")),
                 L.col("v1") + L.col("v2") * 2.0,
                 abs(L.col("v1")) - L.col("v2"),
                 -L.col("v2"))
        node = node.project(_p=exprs[rng.randint(len(exprs))])
        projected = True
    joined = rng.rand() < 0.5
    if joined:
        node = node.join(L.scan("dim"), "fk", "pk",
                         {"_dv": "dv", "_dk": "dk"})
        r = rng.rand()
        if r < 0.3:
            # predicate on a TAKEN column: needs the joined rows, so the
            # partitioned lowering must NOT push it below the Exchange
            node = node.filter(L.col("_dv") <= 0.8)
        elif r < 0.55:
            # predicate on a PROBE-side column only: under a distributed
            # partitioned join the Filter-below-Exchange peephole pushes
            # it below the probe routing — these seeds pin the rewrite's
            # bit-exactness across every executor and placement
            node = node.filter(L.col("d") >= float(rng.randint(5, 40)))
    attached = rng.rand() < 0.35
    if attached:
        # q18's HAVING idiom: gather a per-key1 COUNT back into the rows
        # and threshold it — counts are bit-exact under every lowering, so
        # the resulting selection mask is too
        src = L.scan("fact").aggregate("key1", G1, att=("count", "d"))
        node = node.attach(src, "key1", {"_att": "att"})
        if rng.rand() < 0.6:
            node = node.filter(L.col("_att") > float(rng.randint(40, 70)))
    keys = [("key1", G1), (None, 1)]
    if joined:
        keys.append(("_dk", DK))
    key, n_groups = keys[rng.randint(len(keys))]
    cols = ["v1", "v2"] + (["_p"] if projected else []) \
        + (["_dv"] if joined else []) + (["_att"] if attached else [])
    aggs = {}
    for i in range(int(rng.randint(1, 5))):
        aggs[f"a{i}"] = (AGG_OPS[rng.randint(len(AGG_OPS))],
                         cols[rng.randint(len(cols))])
    if (not any(op in ("median",) or op.startswith("quantile:")
                for op, _ in aggs.values()) and rng.rand() < 0.5):
        aggs["amed"] = ("median", cols[rng.randint(len(cols))])
    root = node.aggregate(key, n_groups, **aggs)
    if key is not None and rng.rand() < 0.35:
        # TopK rides a COUNT output: count values are bit-identical across
        # executors/policies, so the selection (and tie-breaks, which
        # lax.top_k resolves by index) is deterministic everywhere
        aggs["acnt"] = ("count", cols[0])
        root = node.aggregate(key, n_groups, **aggs)
        root = root.top_k("acnt", min(int(rng.randint(3, 9)), n_groups),
                          "top_idx")
    return L.LogicalPlan(root, None)


def _root_aggregate(plan: L.LogicalPlan) -> L.Aggregate:
    node = plan.root
    while isinstance(node, L.TopK):
        node = node.child
    return node


def plan_agg_ops(plan: L.LogicalPlan):
    """{output_name: op} of the plan's Aggregate (for exactness tiers) —
    found below any TopK wrapper. TopK index outputs are integer-exact by
    construction; the harness treats ``top_idx`` specially."""
    return {name: op for name, (op, _c) in _root_aggregate(plan).aggs}


def plan_has_join(plan: L.LogicalPlan) -> bool:
    return any(isinstance(n, L.Join) for n in L.walk(plan.root))


EXACT_OPS = ("count", "max", "min", "median", "distinct")


def exact_output(key: str, ops) -> bool:
    """ONE copy of the exactness tier shared by the in-process and
    subprocess grids: counts, TopK indices, and every order statistic
    (max/min/median/quantile) select or count actual values, so they must
    be BIT-IDENTICAL across all lowerings; everything else (sums/avgs)
    compares to tolerances because reduction order is part of the float
    result, not of the relational answer."""
    op = ops.get(key)
    return (key in ("_count", "top_idx") or op in EXACT_OPS
            or (op is not None and op.startswith("quantile:")))
