"""The metric arithmetic: tails over all requests, rates over the whole
window, the device trace's union and idle gaps, the rooflines
and each per-layer reader, on records made by hand."""
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import compare, devtrace, discovery, roofline, stats, tiny
from bench.runners import tpch as tpch_runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def test_percentile_is_the_nearest_rank_over_every_value():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    # one slow request in twenty is the p95; two are beyond it
    assert stats.percentile([1.0] * 19 + [9.0], 95) == 1.0
    assert stats.percentile([1.0] * 18 + [9.0, 9.0], 95) == 9.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_counts_the_whole_window():
    assert stats.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


class SlowService:
    """Answers each request after the next of ``delays`` seconds."""

    def __init__(self, delays):
        self.delays = list(delays)
        self.waits = {}
        self.scheduler = SimpleNamespace(stats=lambda: SimpleNamespace(
            quarantined_pools=(), requeued=0, executed_per_pool=(),
            pool_ewma_s=()))

    def submit(self, plan, tables, context=None):
        rid = len(self.waits)
        self.waits[rid] = self.delays[rid]
        return rid

    def result(self, rid, timeout=None):
        time.sleep(self.waits[rid])
        return SimpleNamespace(value={"x": np.zeros(1)}, error=None,
                               expired=False, latency_s=self.waits[rid],
                               phases={})


def test_the_tail_keeps_requests_that_straddle_the_close():
    """Four requests are submitted inside a 0.7 s window; the last one
    finishes after the close. The rate counts the three inside the
    window; the p95 is the straddling request's latency."""
    spec = tiny.with_held(discovery.Benchmark(ROOT))
    cell = spec.cell("tpch-sf30.power")
    run = tpch_runner.Cell(cell.config, cell.traffic, 3, CPU)
    run.tables, run.ctx = None, None
    run.service = SlowService([0.2, 0.2, 0.2, 0.6])
    out = run.run(0.7)
    assert out["attempted"] == 4 and out["failed"] == 0
    assert out["end_to_end"]["queries_per_s"] == pytest.approx(3 / 0.7)
    assert out["end_to_end"]["query_p95_ms"] >= 550.0
    assert out["records"]["completed"] == 3
    assert len(out["records"]["requests"]) == 4


def test_union_merge_and_clip():
    iv = [(0, 10), (5, 15), (20, 30), (21, 22)]
    assert devtrace.union_us(iv) == 25
    assert devtrace.merged(iv) == [(0, 15), (20, 30)]
    assert devtrace.clip(iv, 8, 25) == [(8, 10), (8, 15), (20, 25),
                                        (21, 22)]


def tracer_with(events, spans, marker_host=1.0):
    t = devtrace.Tracer(device=None)
    t.events = events
    t.spans = spans
    t._marker_host = marker_host
    return t


def test_records_idle_gaps_by_host_span():
    # trace clock = host clock (us) + 500
    off = 500.0
    ev = [(devtrace.MARKER, 1e6 + off, 1e6 + off + 1),
          ("void agg_partial_kernel<true>(int const*)", 2e6 + off,
           2.5e6 + off),
          ("join_probe_kernel", 3e6 + off, 3.2e6 + off),
          ("Memcpy DtoH", 3.2e6 + off, 3.3e6 + off)]
    spans = [("round", 1.9, 3.8), ("planner.lower", 2.6, 2.9)]
    t = tracer_with(ev, spans)
    t.launches = {"hash_aggregate_multi": [(1, 1000, 1, 10)],
                  "join_probe": [(1, 10, 100)]}
    r = t.records(1.5, 4.0)
    assert r["window_s"] == 2.5
    assert r["busy_s"] == pytest.approx(0.5 + 0.3)
    gaps = dict(r["idle_gaps"])
    assert gaps["host: planner.lower"] == pytest.approx(0.5)
    assert gaps["host: outside every span"] == pytest.approx(0.5)
    assert gaps["host: round"] == pytest.approx(0.7)
    assert dict(r["device_ops"])["agg_partial_kernel"] == pytest.approx(0.5)
    assert r["kernel_s"]["hash_aggregate_multi"] == pytest.approx(0.5)
    assert r["kernel_records"] == {"agg_partial_kernel": 1,
                                   "agg_reduce_kernel": 0,
                                   "join_build_kernel": 0,
                                   "join_probe_kernel": 1}
    share = devtrace.roofline_share(r, "hash_aggregate_multi")
    b, o = roofline.hash_aggregate_multi(1, 1000, 1, 10)
    assert share == pytest.approx(100 * roofline.bound_s(b, o) / 0.5)


def test_roofline_formulas():
    assert roofline.hash_aggregate_multi(64, 3125248, 1, 15744) == (
        4.0 * (64 * 3125248 * 2 + 64 * 15744), 64.0 * 3125248)
    b, o = roofline.join_probe(64, 500096, 8000000)
    assert b == 8.0 * 64 * 500096 + 9.0 * 64 * 8000000
    # W3 at the paper's sizes: a 1.452 ms bound, set by its bytes
    assert roofline.bound_s(b, o) * 1e3 == pytest.approx(1.452, abs=1e-3)


def test_per_layer_readers():
    spec = discovery.Benchmark(ROOT)
    rec = {"window_s": 10.0, "busy_s": 7.5, "completed": 150,
           "requests": [{"latency_s": 0.2, "phases": {
               "queue_wait": 0.05, "batch_wait": 0.01, "execute": 0.1,
               "merge": 0.0, "retry_backoff": 0.0}}] * 3,
           "plan_cache": {"before": {"hits": 10, "misses": 5},
                          "after": {"hits": 40, "misses": 15}}}
    assert spec.metric("idle_share.serve").read(rec) == pytest.approx(25.0)
    assert spec.metric("idle_share.batch").read(rec) == pytest.approx(25.0)
    assert spec.metric("device_ms_per_query").read(rec) == pytest.approx(50)
    assert spec.metric("queue_wait_share").read(rec) == pytest.approx(30.0)
    assert spec.metric("plan_cache_hit_rate").read(rec) == pytest.approx(75)
    for name in ("hash_aggregate_roofline", "join_probe_roofline"):
        assert spec.metric(name).read(rec) is None


def test_judge_reads_relative_gaps_and_exact_integers():
    import numpy as np
    want = {"s": np.array([100.0, 0.0, float("nan")]),
            "n": np.array([3, 4], dtype=np.int64)}
    got = {"s": np.array([100.01, 0.0, float("nan")], dtype=np.float32),
           "n": np.array([3, 5], dtype=np.int64)}
    gap, bad = compare.judge(got, want)
    assert gap == pytest.approx(1e-4, rel=1e-2) and bad == 1
    got["s"] = np.array([100.0, 0.0, 1.0])
    assert math.isinf(compare.judge(got, want)[0])
    assert compare.judge({}, want)[1] == 5
