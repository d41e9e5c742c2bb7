"""The port's spans on a card: every call of W1-W4 that synchronizes the
host with the device falls inside a ``sync`` span, one read for each read
the spans count; and a span's stamps sit on the device trace's clock.

Marked ``cuda``: without a CUDA device each test skips (the kernels and
the synchronizations exist only on a card). This file imports neither jax
nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_spans.py
"""
import json
import time
import warnings

import pytest
import torch

from repro_torch.analytics import aggregate, join, tracing
from repro_torch.analytics.datasets import blanas_join, to_tensors, zipf

CARD = 65_536
# each job's reads of device values: W1 the longest segment; W2 bincount's
# minimum and maximum and the padding key's copy; W3 both sides' bincount
# and padding key and the duplicate flag; W4 radix its bucket bincount
JOBS = {"w1": 1, "w2": 3, "w3": 7, "w4.radix": 2, "w4.sorted": 0,
        "w4.hash": 0}


@pytest.fixture(scope="module")
def w_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the syncs exist only on a card")
    dev = torch.device("cuda")
    x = to_tensors(zipf(2_000_000, CARD, seed=3), dev)
    x.update(to_tensors(blanas_join(200_000, 3_200_000, seed=4), dev))
    return x


def _job(name, x):
    if name == "w1":
        return [aggregate.median_direct(x["keys"], x["vals"], CARD)]
    if name == "w2":
        return list(aggregate.count_partitioned(x["keys"], CARD))
    args = (x["build_keys"], x["build_vals"], x["probe_keys"])
    if name == "w3":
        return list(join.hash_join(*args))
    return list(join.index_join(*args, name.split(".")[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("job", list(JOBS))
def test_cuda_every_sync_of_w1_w4_is_inside_a_sync_span(w_inputs, job):
    want = _job(job, w_inputs)           # the kernels built, blocks cached
    torch.cuda.synchronize()
    calls = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            f = tracing.current()
            calls.append(None if f is None else (f.cat, f.name))

    with tracing.tracing() as tr:
        tr.drain()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            # the first switch of the mode in a process warns by itself
            torch.cuda.set_sync_debug_mode("warn")
            try:
                warnings.showwarning = hook
                got = _job(job, w_inputs)
            finally:
                warnings.showwarning = lambda *a, **k: None
                torch.cuda.set_sync_debug_mode("default")
        spans = tr.drain()
    syncs = [s for s in spans if s.cat == "sync"]
    outside = [c for c in calls if c is None or c[0] != "sync"]
    assert not outside, (job, outside)
    reads = sum(dict(s.args).get("syncs", 1) for s in syncs)
    assert len(calls) == reads == JOBS[job], (
        job, calls, [s.name for s in syncs])
    for a, b in zip(want, got):
        assert torch.equal(torch.nan_to_num(a, nan=-7.0),
                           torch.nan_to_num(b, nan=-7.0))


@pytest.mark.cuda
def test_cuda_a_launch_in_a_span_lands_after_its_start_on_the_trace_clock(
        w_inputs, tmp_path):
    """A marker kernel launched at ``tracing.now()`` after a synchronize
    gives the offset from the program's clock to the trace's; a spin
    kernel launched 2 ms into a span then starts, on the trace's clock,
    no earlier than 2 ms after the span's start and no later than its end
    (50 us allowed each way)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with tracing.tracing() as tr:
        tr.drain()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            mark = tracing.now()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.005)
            with tracing.span("probe", "op"):
                time.sleep(0.002)
                torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
        (s,) = tr.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spins = sorted(float(e["ts"]) for e in events
                   if e.get("cat") == "kernel"
                   and "spin_kernel" in str(e.get("name")))
    assert len(spins) == 2, spins
    offset = spins[0] - mark * 1e6
    start, end = s.t0 * 1e6 + offset, s.t1 * 1e6 + offset
    assert spins[1] >= start + 2000.0 - 50.0, (spins[1] - start)
    assert spins[1] <= end + 50.0, (spins[1] - end)
