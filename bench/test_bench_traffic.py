"""The seeded traffic and data: the same seed repeats exactly, every seed
gives the same sizes and the same mix of work."""
import itertools
import os
from collections import Counter

import torch

from bench import days, discovery, traffic_gen
from bench.datagen import paper_w as wgen
from bench.datagen import tpch as tgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)
CPU = torch.device("cpu")


def take(traffic, seed, index, n):
    return list(itertools.islice(traffic_gen.stream(traffic, seed, index), n))


def test_streams_repeat_exactly_and_differ_between_streams_and_seeds():
    t = discovery.Benchmark(ROOT).traffic("streams4")
    for seed in SEEDS:
        assert take(t, seed, 0, 50) == take(t, seed, 0, 50)
    assert take(t, 5, 0, 50) != take(t, 5, 1, 50)
    assert take(t, 5, 0, 50) != take(t, 6, 0, 50)
    assert take(t, 5, 0, 50) != list(itertools.islice(
        traffic_gen.warmup_stream(t, 5, 0), 50))


def test_every_pass_holds_each_query_once_within_its_domains():
    t = discovery.Benchmark(ROOT).traffic("streams4")
    n = len(t["queries"])
    for seed in SEEDS:
        reqs = take(t, seed, 2, 5 * n)
        for p in range(5):
            assert Counter(name for name, _ in reqs[p * n:(p + 1) * n]) == \
                Counter(t["queries"])
        for name, params in reqs:
            domains = t["params"][name]
            assert set(params) == set(domains)
            for k, (lo, hi) in domains.items():
                assert traffic_gen.bound(lo) <= params[k] <= \
                    traffic_gen.bound(hi)


def test_tpch_parameters_map_to_the_ports_days():
    assert days.day("1992-01-01") == 0
    assert days.Q1_BASE == 2526
    assert days.year_range(1996) == (1461, 1827)
    assert days.day("1995-03-01") == 1155


def test_tpch_tables_repeat_and_keep_their_sizes():
    rows = {"orders": 700, "customer": 90, "supplier": 10, "part": 200}
    a = tgen.make_tables(rows, 3, CPU)
    b = tgen.make_tables(rows, 3, CPU)
    c = tgen.make_tables(rows, 4, CPU)
    for t in a:
        for col in a[t]:
            assert torch.equal(a[t][col], b[t][col])
            assert a[t][col].shape == c[t][col].shape
    li = a["lineitem"]
    assert li["l_orderkey"].shape[0] == tgen.lineitem_rows(700) == 2800
    assert torch.all(li["l_orderkey"][1:] >= li["l_orderkey"][:-1])
    lag = li["l_shipdate"] - a["orders"]["o_orderdate"][li["l_orderkey"].long()]
    assert int(lag.min()) >= 1 and int(lag.max()) <= 121
    ck = a["orders"]["o_custkey"]
    assert int(ck.max()) < 90 and not torch.any((ck + 1) % 3 == 0)
    assert set(li["l_returnflag"].tolist()) <= {0, 1, 2}
    assert not torch.equal(a["lineitem"]["l_quantity"],
                           c["lineitem"]["l_quantity"])
    assert tgen.lineitem_rows(45_000_000) == 179_999_994


def test_w_inputs_repeat_and_keep_their_sizes():
    sizes = {"agg": {"records": 5000, "groups": 300},
             "join": {"build": 400, "probe": 3000, "key_space": 1600}}
    dist = {"kind": "zipf", "exponent": 0.5}
    a = wgen.make_inputs(sizes, {"agg", "join"}, dist, 9, CPU)
    b = wgen.make_inputs(sizes, {"agg", "join"}, dist, 9, CPU)
    c = wgen.make_inputs(sizes, {"agg", "join"}, dist, 10, CPU)
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].shape == c[k].shape
    assert int(a["keys"].min()) >= 0 and int(a["keys"].max()) < 300
    assert torch.unique(a["build_keys"]).numel() == 400
    assert torch.isin(a["probe_keys"], a["build_keys"]).all()


def test_fixed_orders_are_kept_pass_after_pass():
    spec = discovery.Benchmark(ROOT)
    for mix in ("streams4", "power"):
        t = spec.traffic(mix)
        n = len(t["queries"])
        for i, order in enumerate(t["orders"]):
            names = [q for q, _ in take(t, 3, i, 3 * n)]
            assert names == list(order) * 3
    bad = dict(t, orders=[["q1"]])
    try:
        next(traffic_gen.stream(bad, 1, 0))
    except ValueError:
        pass
    else:
        raise AssertionError("an order that is not a permutation ran")
