"""A run with the timed path broken underneath reads ``correct`` false:
an answer altered where it is produced, half of the rows left out, and
(for the served cells) a stale answer served again. The look for a card
is skipped; the rest of a run is the harness's own (bench/tiny.py)."""
import os

import pytest
import torch

from bench import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVED = ("tpch-sf30.streams4", "tpch-sf30.power")


def judged_wrong(name: str, seconds: float = 1.0) -> bool:
    """A tiny run of ``name`` judged some answers and read incorrect."""
    line = tiny.run(name, root=ROOT, seconds=seconds)
    assert line["checks"]["answers"]["value"] >= 1, line["checks"]
    return not line["correct"]


def nudged(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its first element moved by 1e-3 of itself (or by 1)."""
    t = t.clone()
    flat = t.view(-1)
    if flat.numel():
        if t.dtype.is_floating_point:
            flat[0] = flat[0] * 1.001 if flat[0] != 0 else 1.0
        else:
            flat[0] += 1
    return t


@pytest.fixture
def service_cls():
    from repro_torch.analytics.service import AnalyticsService
    return AnalyticsService


@pytest.mark.parametrize("name", SERVED)
def test_altered_answer(name, monkeypatch, service_cls):
    orig = service_cls.result

    def result(self, rid, timeout=None):
        res = orig(self, rid, timeout)
        if res is not None and res.value is not None:
            first = sorted(k for k in res.value if not k.startswith("_"))[0]
            res.value[first] = nudged(res.value[first])
        return res
    monkeypatch.setattr(service_cls, "result", result)
    assert judged_wrong(name)


@pytest.mark.parametrize("name", SERVED)
def test_half_the_rows(name, monkeypatch, service_cls):
    orig = service_cls.submit

    def submit(self, plan, tables, **kw):
        li = {c: v[: v.shape[0] // 2] for c, v in tables["lineitem"].items()}
        return orig(self, plan, dict(tables, lineitem=li), **kw)
    monkeypatch.setattr(service_cls, "submit", submit)
    assert judged_wrong(name)


@pytest.mark.parametrize("name", SERVED)
def test_stale_answer(name, monkeypatch, service_cls):
    orig, last = service_cls.result, {}

    def result(self, rid, timeout=None):
        res = orig(self, rid, timeout)
        if res is not None and res.value is not None:
            shape = tuple(sorted(res.value))
            res.value, last[shape] = last.get(shape, res.value), res.value
        return res
    monkeypatch.setattr(service_cls, "result", result)
    assert judged_wrong(name, seconds=2.0)


def test_w_altered_answers(monkeypatch):
    from repro_torch.analytics import aggregate, join
    med, cnt = aggregate.median_direct, aggregate.count_partitioned
    hj, ij = join.hash_join, join.index_join
    monkeypatch.setattr(aggregate, "median_direct",
                        lambda *a, **k: nudged(med(*a, **k)))
    assert judged_wrong("paper-w.agg")
    monkeypatch.setattr(aggregate, "median_direct", med)
    monkeypatch.setattr(aggregate, "count_partitioned",
                        lambda *a, **k: (nudged(cnt(*a, **k)[0]),
                                         cnt(*a, **k)[1]))
    assert judged_wrong("paper-w.agg")
    monkeypatch.setattr(join, "hash_join", lambda *a, **k: (
        lambda n, s, o: (n, nudged(s), o))(*hj(*a, **k)))
    monkeypatch.setattr(join, "index_join", lambda *a, **k: (
        lambda n, s: (n, nudged(s)))(*ij(*a, **k)))
    assert judged_wrong("paper-w.join")


def test_w_half_the_rows(monkeypatch):
    from repro_torch.analytics import aggregate, join
    med, cnt = aggregate.median_direct, aggregate.count_partitioned
    hj, ij = join.hash_join, join.index_join

    def half(x):
        return x[: x.shape[0] // 2]
    monkeypatch.setattr(aggregate, "median_direct",
                        lambda k, v, g: med(half(k), half(v), g))
    monkeypatch.setattr(aggregate, "count_partitioned",
                        lambda k, g, **kw: cnt(half(k), g, **kw))
    assert judged_wrong("paper-w.agg")
    monkeypatch.setattr(join, "hash_join",
                        lambda b, v, p, **kw: hj(b, v, half(p), **kw))
    monkeypatch.setattr(join, "index_join",
                        lambda b, v, p, kind: ij(b, v, half(p), kind))
    assert judged_wrong("paper-w.join")
