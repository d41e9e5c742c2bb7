"""The port's placement-policy distributed backend against the JAX
reference on the same numpy inputs.

(c) The engine primitives: the reference runs them under ``shard_map`` on
a mesh of 4 fake CPU devices in one subprocess (``run_with_devices``) and
saves what each shard returns; the port runs them on a virtual mesh of 4
shards on the CPU. Integers, routed keys, weights, overflow counts and
order statistics are equal; float sums agree within the reference's own
executor-parity tolerance (atol=1e-3, rtol=1e-4), since the two meshes add
partials in different orders.

(d) The seven TPC-H queries under each placement policy and both Exchange
layouts at scale 0.004, seed 1, on 4 shards, against the reference's
single-device ``run_query`` on the same data, plus the port's own
promises: argsort == radix and candidates TopK == replicated, bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.analytics import datasets as RD
from repro.analytics import planner as RP
from repro.analytics import tpch as R
from repro_torch.analytics import datasets as TD
from repro_torch.analytics import engine as E
from repro_torch.analytics import planner as TP
from repro_torch.analytics import tpch as T
from repro_torch.analytics.columnar import segment_sum
from repro_torch.core.config import PlacementPolicy
from repro_torch.core.vmesh import VirtualMesh

N = 4                     # shards
PER = 1000                # rows per shard of the primitive inputs
G = 50                    # groups of the primitive inputs
W_N, W_CARD, W_BUILD = 1 << 14, 1000, 1024      # W1-W3 sizes
POLICIES = [p.name for p in PlacementPolicy]
F_TOL = dict(atol=1e-3, rtol=1e-4)


def _inputs():
    """Per-shard primitive inputs, (N, PER, ...) stacks."""
    rng = np.random.RandomState(11)
    keys = rng.randint(0, G, (N, PER)).astype(np.int32)
    keys[:, ::9] = -1                               # dead padding rows
    w = (rng.rand(N, PER) > 0.2).astype(np.float32)
    w[keys < 0] = 0.0
    vals = (rng.rand(N, PER) * 100).astype(np.float32)
    vals2 = rng.randint(0, 7, (N, PER)).astype(np.float32)  # ties
    stacked = np.stack([w, vals * w, vals2 * w], axis=-1)
    table = (rng.randn(N, G, 3) * 10).astype(np.float32)
    # placed: shard i holds exactly the groups g with g % N == i
    placed = rng.randint(0, G // N, (N, PER)).astype(np.int32) * N
    placed += np.arange(N, dtype=np.int32)[:, None]
    return dict(keys=keys, w=w, vals=vals, vals2=vals2, stacked=stacked,
                table=table, placed=placed)


REF_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.analytics import datasets as D
from repro.analytics import engine as E
from repro.core.config import PlacementPolicy as PP

inp = dict(np.load(sys.argv[1]))
N, G = 4, 50
mesh = Mesh(np.array(jax.devices()[:N]), ("d",))
out = {}


def smap(name, f, *arrs):
    flat = [jnp.asarray(a.reshape((-1,) + a.shape[2:])) for a in arrs]
    g = jax.jit(shard_map(
        lambda *xs: jax.tree_util.tree_map(lambda y: jnp.asarray(y)[None],
                                           f(*xs)),
        mesh=mesh, in_specs=tuple(P("d") for _ in flat), out_specs=P("d"),
        check_rep=False))
    res = jax.tree_util.tree_map(np.asarray, g(*flat))
    for path, leaf in jax.tree_util.tree_flatten_with_path(res)[0]:
        out[name + jax.tree_util.keystr(path)] = leaf


def route(impl, cap):
    def f(k, v, w):
        owner = E.route_owner(k, w > 0, N, "hash")
        fn = E.radix_route_table_rows if impl == "radix" else E.route_table_rows
        cols, wout, ovf = fn({"k": k, "v": v}, w, owner, N, cap, "d")
        return cols["k"], cols["v"], wout, ovf
    return f


for cap in (512, 128):
    for impl in ("argsort", "radix"):
        smap(f"route_{impl}_{cap}", route(impl, cap), inp["keys"],
             inp["vals"], inp["w"])
for cap in (2000, 600):
    smap(f"compact_{cap}",
         lambda k, v, w, cap=cap: E.compact_routed_rows(
             {"k": k, "v": v}, w, cap),
         inp["keys"], inp["vals"], inp["w"])
smap("pushdown", lambda t: E.pushdown_group_sums(t, G, "d", N), inp["table"])
smap("merge_ft", lambda t: E.merge_partial_table(t, PP.FIRST_TOUCH, "d", N),
     inp["table"])
smap("merge_la", lambda t: E.merge_partial_table(t, PP.LOCAL_ALLOC, "d", N),
     inp["table"])
agg = lambda ids, v, n: (jax.ops.segment_sum(v, ids, num_segments=n),
                         jnp.zeros((), jnp.int32))
for cap in (None, 128):
    smap(f"interleave_sums_{cap}",
         lambda k, s, cap=cap: E.interleave_group_sums(
             k, s, G, "d", N, agg, capacity=cap),
         inp["keys"], inp["stacked"])
RANKS = {"b": 0.25, "c": "distinct"}
smap("median_replicated",
     lambda k, w, a, b: E.replicated_group_median(
         k, {"a": a, "b": b, "c": b}, w, G, "d", ranks=RANKS),
     inp["keys"], inp["w"], inp["vals"], inp["vals2"])
smap("median_interleave",
     lambda k, w, a, b: E.interleave_group_median(
         k, {"a": a, "b": b, "c": b}, w, G, "d", N, ranks=RANKS),
     inp["keys"], inp["w"], inp["vals"], inp["vals2"])
smap("median_placed",
     lambda k, w, a, b: E.placed_group_median(
         k, {"a": a, "b": b, "c": b}, w, G, "d", ranks=RANKS),
     inp["placed"], inp["w"], inp["vals"], inp["vals2"])

agg_ds = D.zipf(1 << 14, 1000, seed=0)
join_ds = D.blanas_join(1024, 1 << 14, seed=0)
for p in PP:
    out[f"count_{p.name}"] = np.asarray(
        E.dist_count(mesh, p, 1000, axis="d")(jnp.asarray(agg_ds.keys)))
    out[f"count_rebalance_{p.name}"] = np.asarray(
        E.dist_count(mesh, p, 1000, axis="d", auto_rebalance=True)(
            jnp.asarray(agg_ds.keys)))
    out[f"median_{p.name}"] = np.asarray(
        E.dist_median(mesh, p, 1000, axis="d")(
            jnp.asarray(agg_ds.keys), jnp.asarray(agg_ds.vals)))
    c, s = E.dist_hash_join(mesh, p, axis="d")(
        jnp.asarray(join_ds.build_keys), jnp.asarray(join_ds.build_vals),
        jnp.asarray(join_ds.probe_keys))
    out[f"join_{p.name}"] = np.array([c, s])
# forced overflow: too small a routing capacity under INTERLEAVE
out["count_overflow"] = np.asarray(E.dist_count(
    mesh, PP.INTERLEAVE, 1000, axis="d", capacity_factor=0.5)(
        jnp.asarray(agg_ds.keys)))
c, s = E.dist_hash_join(mesh, PP.INTERLEAVE, axis="d",
                        capacity_factor=0.5)(
    jnp.asarray(join_ds.build_keys), jnp.asarray(join_ds.build_vals),
    jnp.asarray(join_ds.probe_keys))
out["join_overflow"] = np.array([c, s])

# holistic routing overflow at 8 shards: qm/qq's 3 groups land on 3 of 8
# owners, past the routing capacity (the records beyond it are dropped and
# counted in _overflow)
from repro.analytics import planner as RPL
from repro.analytics import tpch as RT
mesh8 = Mesh(np.array(jax.devices()[:8]), ("data",))
tp = RT.generate(scale=0.004, seed=1)
for q in ("qm", "qq"):
    res = RT.run_query(q, tp, context=RPL.ExecutionContext(
        mesh=mesh8, policy=PP.INTERLEAVE))
    for k, v in res.items():
        out[f"tpch8_{q}_{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ref")
    inp_path, out_path = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
    np.savez(inp_path, **_inputs())
    run_with_devices(REF_SCRIPT.replace("sys.argv[1]", repr(inp_path))
                     .replace("sys.argv[2]", repr(out_path)),
                     n_devices=8, timeout=600)
    return dict(np.load(out_path))


def _port(fn, *arrs):
    """Run ``fn(comm, *shard_arrays)`` on a 4-shard virtual mesh on the
    CPU; every output leaf stacked over shards like the reference's."""
    mesh = VirtualMesh(N, "cpu", timeout=60)
    outs = mesh.run(lambda comm, xs: fn(comm, *xs),
                    [tuple(torch.from_numpy(np.ascontiguousarray(a[i]))
                           for a in arrs) for i in range(N)])
    return outs


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def _ref_leaves(ref, name):
    keys = sorted((k for k in ref if k == name or k.startswith(name + "[")),
                  key=lambda k: [int(s) if s.isdigit() else s for s in
                                 k.replace("]", "[").replace("'", "")
                                 .split("[")])
    return [ref[k] for k in keys]


def _same(got, want, label, floats="close"):
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating) and floats == "close":
        np.testing.assert_allclose(got, want, err_msg=label, **F_TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


def _compare(ref, name, outs, floats="close"):
    shards = [_leaves(o) for o in outs]
    got = [np.stack([s[i].numpy() for s in shards])
           for i in range(len(shards[0]))]
    want = _ref_leaves(ref, name)
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{name}[{i}]", floats)
    return got


@pytest.mark.parametrize("cap", [512, 128])
@pytest.mark.parametrize("impl", ["argsort", "radix"])
def test_route_table_rows_match_reference(ref, impl, cap):
    inp = _inputs()

    def f(comm, k, v, w):
        owner = E.route_owner(k, w > 0, N, "hash")
        fn = (E.radix_route_table_rows if impl == "radix"
              else E.route_table_rows)
        cols, wout, ovf = fn({"k": k, "v": v}, w, owner, N, cap, comm)
        assert ovf.dtype == torch.int32
        return cols["k"], cols["v"], wout, ovf

    got = _compare(ref, f"route_{impl}_{cap}",
                   _port(f, inp["keys"], inp["vals"], inp["w"]),
                   floats="equal")             # routing moves, never adds
    assert (got[3].sum() > 0) == (cap == 128)  # the small budget overflows


def test_radix_route_equals_argsort_route_bit_for_bit():
    inp = _inputs()
    outs = {}
    for impl in ("argsort", "radix"):
        def f(comm, k, v, w, impl=impl):
            owner = E.route_owner(k, w > 0, N, "modulo")
            fn = (E.radix_route_table_rows if impl == "radix"
                  else E.route_table_rows)
            cols, wout, ovf = fn({"k": k, "v": v}, w, owner, N, 256, comm)
            return cols["k"], cols["v"], wout, ovf
        outs[impl] = _port(f, inp["keys"], inp["vals"], inp["w"])
    for a, b in zip(outs["argsort"], outs["radix"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("cap", [2000, 600])
def test_compact_routed_rows_matches_reference(ref, cap):
    inp = _inputs()
    _compare(ref, f"compact_{cap}", _port(
        lambda comm, k, v, w: E.compact_routed_rows({"k": k, "v": v}, w,
                                                    cap),
        inp["keys"], inp["vals"], inp["w"]), floats="equal")


@pytest.mark.parametrize("name", ["pushdown", "merge_ft", "merge_la"])
def test_partial_table_merges_match_reference(ref, name):
    inp = _inputs()
    fns = {
        "pushdown": lambda c, t: E.pushdown_group_sums(t, G, c, N),
        "merge_ft": lambda c, t: E.merge_partial_table(
            t, PlacementPolicy.FIRST_TOUCH, c, N),
        "merge_la": lambda c, t: E.merge_partial_table(
            t, PlacementPolicy.LOCAL_ALLOC, c, N),
    }
    got = _compare(ref, name, _port(fns[name], inp["table"]))
    for shard in got[0][1:]:                     # replicated on every shard
        np.testing.assert_array_equal(shard, got[0][0])


@pytest.mark.parametrize("cap", [None, 128])
def test_interleave_group_sums_match_reference(ref, cap):
    inp = _inputs()

    def agg(ids, v, n):
        return segment_sum(v, ids, n), torch.zeros((), dtype=torch.int32)

    got = _compare(ref, f"interleave_sums_{cap}", _port(
        lambda c, k, s: E.interleave_group_sums(k, s, G, c, N, agg,
                                                capacity=cap),
        inp["keys"], inp["stacked"]))
    assert (got[1].sum() > 0) == (cap == 128)


RANKS = {"b": 0.25, "c": "distinct"}


@pytest.mark.parametrize("lowering", ["replicated", "interleave", "placed"])
def test_median_lowerings_match_reference(ref, lowering):
    inp = _inputs()

    def f(c, k, w, a, b):
        cols = {"a": a, "b": b, "c": b}
        if lowering == "replicated":
            return E.replicated_group_median(k, cols, w, G, c, ranks=RANKS)
        if lowering == "interleave":
            return E.interleave_group_median(k, cols, w, G, c, N,
                                             ranks=RANKS)
        return E.placed_group_median(k, cols, w, G, c, ranks=RANKS)

    keys = inp["placed"] if lowering == "placed" else inp["keys"]
    # order statistics and counts are exact; the quantile interpolates
    _compare(ref, f"median_{lowering}",
             _port(f, keys, inp["w"], inp["vals"], inp["vals2"]),
             floats="equal")


@pytest.fixture(scope="module")
def w_data():
    agg = RD.zipf(W_N, W_CARD, seed=0)
    join = RD.blanas_join(W_BUILD, W_N, seed=0)
    return TD.to_tensors(TD.zipf(W_N, W_CARD, seed=0), "cpu"), \
        TD.to_tensors(TD.blanas_join(W_BUILD, W_N, seed=0), "cpu"), agg, join


def test_datasets_match_reference_bit_for_bit(w_data):
    agg_t, join_t, agg, join = w_data
    for name, t in agg_t.items():
        a = getattr(agg, name)
        assert t.numpy().dtype == a.dtype and np.array_equal(t.numpy(), a)
    for name, t in join_t.items():
        a = getattr(join, name)
        assert t.numpy().dtype == a.dtype and np.array_equal(t.numpy(), a)
    for gen in ("moving_cluster", "sequential", "heavy_hitter"):
        a, b = RD.AGG_DATASETS[gen](3000, 100), TD.AGG_DATASETS[gen](3000, 100)
        assert np.array_equal(a.keys, b.keys) and np.array_equal(a.vals,
                                                                  b.vals)


@pytest.mark.parametrize("policy", POLICIES)
def test_w1_w2_w3_match_reference_under_each_policy(ref, w_data, policy):
    agg_t, join_t, _, _ = w_data
    p = PlacementPolicy[policy]
    kw = dict(device="cpu")
    counts = E.dist_count(N, p, W_CARD, **kw)(agg_t["keys"])
    _same(counts.numpy(), ref[f"count_{policy}"], "count", "equal")
    reb = E.dist_count(N, p, W_CARD, auto_rebalance=True, **kw)(
        agg_t["keys"])
    _same(reb.numpy(), ref[f"count_rebalance_{policy}"], "rebalance",
          "equal")
    med = E.dist_median(N, p, W_CARD, **kw)(agg_t["keys"], agg_t["vals"])
    _same(med.numpy(), ref[f"median_{policy}"], "median", "equal")
    c, s = E.dist_hash_join(N, p, **kw)(join_t["build_keys"],
                                        join_t["build_vals"],
                                        join_t["probe_keys"])
    want = ref[f"join_{policy}"]
    assert float(c) == want[0] == W_N
    np.testing.assert_allclose(float(s), want[1], **F_TOL)


def test_w2_w3_forced_overflow_matches_reference(ref, w_data):
    agg_t, join_t, _, _ = w_data
    p = PlacementPolicy.INTERLEAVE
    counts = E.dist_count(N, p, W_CARD, capacity_factor=0.5,
                          device="cpu")(agg_t["keys"])
    _same(counts.numpy(), ref["count_overflow"], "count", "equal")
    assert counts.sum() < W_N                    # groups were dropped
    c, s = E.dist_hash_join(N, p, capacity_factor=0.5, device="cpu")(
        join_t["build_keys"], join_t["build_vals"], join_t["probe_keys"])
    want = ref["join_overflow"]
    assert float(c) == want[0] < W_N
    np.testing.assert_allclose(float(s), want[1], **F_TOL)


def test_dist_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    p = PlacementPolicy.INTERLEAVE
    for make in (lambda: E.dist_count(N, p, 10),
                 lambda: E.dist_median(N, p, 10),
                 lambda: E.dist_hash_join(N, p),
                 lambda: TD.to_tensors(TD.zipf(100, 10))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# (d) distributed TPC-H against the reference's single-device run
# ---------------------------------------------------------------------------
EXACT = ("o_orderkey", "count_order", "_count", "_overflow", "med_qty",
         "med_price")


@pytest.fixture(scope="module")
def tpch_data():
    ref = R.generate(scale=0.004, seed=1)
    want = {q: {k: np.asarray(v) for k, v in R.run_query(
        q, ref, context=RP.ExecutionContext(executor="xla")).items()}
        for q in R.LOGICAL_QUERIES}
    return T.from_numpy(ref.tables, ref.scale, device="cpu"), want


def _ctx(policy, impl, **kw):
    return TP.ExecutionContext(n_shards=N, policy=PlacementPolicy[policy],
                               dist_join="partitioned", exchange_impl=impl,
                               **kw)


def _check_query(name, got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k in EXACT or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{name}/{k}")
        elif k.startswith("p") and name == "qq":      # interpolated quantiles
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:                                         # f32 sums, any order
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(T.LOGICAL_QUERIES))
def test_distributed_query_matches_reference_and_radix_equals_argsort(
        tpch_data, name, policy):
    data, want = tpch_data
    got = {impl: T.run_query(name, data, context=_ctx(policy, impl))
           for impl in ("argsort", "radix")}
    _check_query(name, got["argsort"], want[name])
    for k, v in got["argsort"].items():        # the layouts' bits agree
        r = got["radix"][k]
        assert r.dtype == v.dtype and torch.equal(
            torch.nan_to_num(r, nan=-7.0), torch.nan_to_num(v, nan=-7.0)), k


@pytest.mark.parametrize("policy", POLICIES)
def test_candidates_topk_equals_replicated_bit_for_bit(tpch_data, policy):
    data, want = tpch_data
    out = {mode: T.run_query("q3", data, context=_ctx(policy, "cost",
                                                      dist_topk=mode))
           for mode in ("candidates", "replicated")}
    _check_query("q3", out["candidates"], want["q3"])
    for k in out["replicated"]:
        assert torch.equal(out["candidates"][k], out["replicated"][k]), k


@pytest.mark.parametrize("name", ["qm", "qq"])
def test_holistic_routing_overflow_at_8_shards_matches_reference(
        ref, tpch_data, name):
    """Under INTERLEAVE on 8 shards the 3 return-flag groups route to 3
    owners whose capacity (2x a balanced share) cannot hold them: both
    implementations drop the same records, count them in _overflow, and
    select the same order statistics from what is left."""
    data, _ = tpch_data
    got = T.run_query(name, data, context=TP.ExecutionContext(
        n_shards=8, policy=PlacementPolicy.INTERLEAVE))
    assert int(got["_overflow"]) > 0
    for k, v in got.items():
        _same(v.numpy(), ref[f"tpch8_{name}_{k}"], f"{name}/{k}",
              "equal" if k in EXACT or k.startswith(("med", "p"))
              else "close")
