"""The traced run's records: the device's work under ``torch.profiler``,
the launch shapes of the port's two analytics kernels, and host spans
around the calls the benchmark makes or wraps.

Only the device's activity is traced (no host operators): a window of
tens of seconds holds hundreds of thousands of launches. Host spans are
the benchmark's own, on ``time.perf_counter``; one marker kernel launched
right after a synchronize ties that clock to the trace's. The program is
not edited: launch shapes are recorded by wrapping the kernels' launch
functions (``ops._launch``) for the traced run only.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from bench import roofline

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
SHORT_GAP_US = 50.0


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def device_events(trace_path: str) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every kernel, copy and memset in a
    torch.profiler Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            ts = float(e["ts"])
            out.append((str(e.get("name", "?")), ts, ts + float(e["dur"])))
    return out


def short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    if base.startswith("void "):
        base = base[5:]
    return base.split("<")[0][:96] or name[:96]


class Tracer:
    """One traced window: ``start``, the runner's work, ``stop``, then
    ``records``."""

    def __init__(self, device):
        self.device = device
        self.launches: Dict[str, list] = {k: [] for k in roofline.FORMULAS}
        self.spans: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()
        self._undo: list = []
        self._prof = None
        self._marker_host = 0.0
        self.events: List[Tuple[str, float, float]] = []

    # -- host spans and wrappers --------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.spans.append((name, t0, time.perf_counter()))

    def wrap(self, owner, attr: str, name: str) -> None:
        """Record a span around every call of ``owner.attr``."""
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            with self.span(name):
                return orig(*a, **kw)
        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def record_launches(self) -> None:
        """Wrap the two analytics kernels' launch functions."""
        from repro_torch.kernels.hash_aggregate import ops as agg
        from repro_torch.kernels.join_probe import ops as jp
        agg_launch, jp_launch = agg._launch, jp._launch

        def agg_wrapped(ids, vals, *, n_bins):
            P, T = ids.shape
            C = vals.shape[2] if vals.dim() == 3 else 0
            if 0 < C <= agg.MAX_C and P and T:
                with self._lock:
                    self.launches["hash_aggregate_multi"].append(
                        (P, T, C, n_bins))
            return agg_launch(ids, vals, n_bins=n_bins)

        def jp_wrapped(build_keys, build_vals, probe_keys):
            P, Pk = probe_keys.shape
            if P and Pk:
                with self._lock:
                    self.launches["join_probe"].append(
                        (P, build_keys.shape[1], Pk))
            return jp_launch(build_keys, build_vals, probe_keys)
        agg._launch, jp._launch = agg_wrapped, jp_wrapped
        self._undo.append(lambda: setattr(agg, "_launch", agg_launch))
        self._undo.append(lambda: setattr(jp, "_launch", jp_launch))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()

    # -- the profiler ---------------------------------------------------------
    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.events = device_events(path)
        finally:
            os.unlink(path)
        self._prof = None
        self.unwrap()

    def _offset_us(self) -> float:
        """Trace time minus host time, in us, from the marker kernel."""
        marks = [s for n, s, _ in self.events if MARKER in n]
        if not marks:
            raise RuntimeError("the trace lost its marker kernel")
        return min(marks) - self._marker_host * 1e6

    def records(self, t_open: float, t_close: float) -> dict:
        """What the per-layer metrics read: the device's union over the
        window [t_open, t_close] (host clock), kernel seconds by name over
        the whole trace, the launch shapes, the idle gaps by host span;
        and how many times each analytics kernel ran on the device."""
        work = [e for e in self.events if MARKER not in e[0]]
        if not work:
            raise RuntimeError("torch.profiler recorded no device work")
        off = self._offset_us()
        lo, hi = t_open * 1e6 + off, t_close * 1e6 + off
        inside = clip([(s, e) for _, s, e in work], lo, hi)
        busy_us = union_us(inside)
        by_name: Dict[str, float] = {}
        whole: Dict[str, float] = {}
        for n, s, e in work:
            whole[n] = whole.get(n, 0.0) + (e - s) / 1e6
            c = clip([(s, e)], lo, hi)
            if c:
                k = short(n)
                by_name[k] = by_name.get(k, 0.0) + (c[0][1] - c[0][0]) / 1e6
        kernel_s = {k: sum(t for n, t in whole.items()
                           if any(m in n for m in names))
                    for k, names in roofline.KERNEL_NAMES.items()}
        kernel_n = {m: sum(1 for n, _, _ in work if m in n)
                    for names in roofline.KERNEL_NAMES.values()
                    for m in names}
        return {"window_s": t_close - t_open, "busy_s": busy_us / 1e6,
                "device_ops": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:TOP],
                "idle_gaps": self._gaps(merged(inside), lo, hi, off),
                "kernel_s": kernel_s, "kernel_records": kernel_n,
                "launches": {k: list(v) for k, v in self.launches.items()}}

    def _gaps(self, busy, lo: float, hi: float, off: float):
        """Idle seconds of the window by the innermost host span open at
        each gap's middle; gaps under SHORT_GAP_US are one entry."""
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        total: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < SHORT_GAP_US:
                label = f"gaps under {SHORT_GAP_US:g} us (launch latency)"
            else:
                label = "host: outside every span"
                mid = ((a + b) / 2 - off) / 1e6
                i = bisect.bisect_right(starts, mid)
                for name, _t0, t1 in reversed(spans[max(0, i - 64):i]):
                    if t1 >= mid:
                        label = f"host: {name}"
                        break
            total[label] = total.get(label, 0.0) + (b - a) / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]


def roofline_share(records: dict, kernel: str) -> Optional[float]:
    """Percent of the roofline that ``kernel``'s launches reached: the
    sum of their bound times over the device time of their kernels."""
    shapes = records.get("launches", {}).get(kernel) or []
    took = records.get("kernel_s", {}).get(kernel, 0.0)
    if not shapes or took <= 0:
        return None
    formula = roofline.FORMULAS[kernel]
    bound = sum(roofline.bound_s(*formula(*s)) for s in shapes)
    return 100.0 * bound / took
