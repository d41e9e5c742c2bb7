"""Request-scoped tracing: the port of ``repro.analytics.tracing``.

Telemetry (telemetry.py) answers "where do the ROWS go"; this module
answers "where does the TIME go". A tracer threads one trace id (the
request id, or the dispatch id for plan-level work) through every phase
it is told about. The planner records two:

  plan.compile      plan-cache miss: lowering + building the callable
  plan.execute      one CompiledPlan dispatch (per plan-cache key)

and the serving tier, when ported, adds queue.wait, batch.group,
dispatch.build, retry.backoff, morsel.run, morsel.steal, merge.partials
and result.deliver.

Discipline, as in ``telemetry.StatsRegistry``:

  * one module-level flag (``enable_tracing`` / ``disable_tracing`` /
    the ``tracing()`` context manager); every instrumentation site is
    behind ``if tracing_enabled():``. Disabled (the default), the hot
    path makes ONE module-attribute read and allocates nothing
    (``Tracer.created`` counts every span and instant allocated, so the
    zero-cost contract can be asserted);
  * the span ring is BOUNDED (``maxlen``) and thread-safe;
  * spans are recorded on the host only and the flag is NOT part of the
    plan-cache key: only telemetry's ``record`` flag changes what a plan
    runs.

Spans read the host's clock. CUDA launches are asynchronous, so a span
around work on a card covers the host's issue of that work, not its
completion on the device.

Exports:

  * ``Trace.to_chrome_trace()``: Chrome trace-event JSON (perfetto
    loads it): ``ph:"X"`` complete events with pid/tid lanes per
    pool/worker plus ``ph:"M"`` metadata naming the lanes;
  * ``render_timeline()``: a deterministic text timeline (golden-
    snapshotted, as ``explain_analyze`` is);
  * ``FlightRecorder``: a bounded ring of postmortem dumps, the recent
    span window snapshotted at the moment a fault trips.

Standard library only and leaf-level: the planner imports this module,
never the reverse.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# enable flag (the telemetry.py discipline)
# ---------------------------------------------------------------------------
_ENABLED = False
_ENABLE_LOCK = threading.Lock()


def tracing_enabled() -> bool:
    return _ENABLED


def enable_tracing() -> None:
    global _ENABLED
    with _ENABLE_LOCK:
        _ENABLED = True


def disable_tracing() -> None:
    global _ENABLED
    with _ENABLE_LOCK:
        _ENABLED = False


@contextmanager
def tracing():
    """Enable tracing for the duration of a block (not reference counted:
    nested blocks share the one global flag)."""
    prev = _ENABLED
    enable_tracing()
    try:
        yield tracer()
    finally:
        if not prev:
            disable_tracing()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Span:
    """One finished span: a named [t0, t0+dur) interval on a (pid, tid)
    lane, tied to a request (``trace_id``) and optionally nested under a
    parent span. ``dur == 0.0`` marks an instant event."""

    name: str
    cat: str                      # phase family: queue|batch|service|...
    t0: float                     # time.monotonic seconds
    dur: float
    trace_id: int = -1            # request/dispatch id; -1 = unscoped
    span_id: int = -1
    parent_id: int = -1
    pid: str = "service"          # process lane (pool / service / plan)
    tid: str = "main"             # thread lane (worker name)
    args: Tuple[Tuple[str, Any], ...] = ()

    @property
    def t1(self) -> float:
        return self.t0 + self.dur

    @property
    def instant(self) -> bool:
        return self.dur == 0.0


@dataclass
class FlightDump:
    """One postmortem artifact: the recent-span window at the moment a
    fault tripped, plus whatever the trip site wanted on record."""

    reason: str
    at: float                     # time.monotonic of the trip
    args: Dict[str, Any] = field(default_factory=dict)
    spans: List[Span] = field(default_factory=list)


class FlightRecorder:
    """Bounded ring of FlightDumps (thread-safe). The tracer owns one;
    trip sites call ``tracer().flight_dump(reason, **args)``."""

    def __init__(self, max_dumps: int = 64):
        self._lock = threading.Lock()
        self._dumps: "deque[FlightDump]" = deque(maxlen=max_dumps)

    def add(self, dump: FlightDump) -> None:
        with self._lock:
            self._dumps.append(dump)

    def dumps(self) -> List[FlightDump]:
        with self._lock:
            return list(self._dumps)

    def clear(self) -> None:
        with self._lock:
            self._dumps.clear()


class _OpenSpan:
    __slots__ = ("name", "cat", "t0", "trace_id", "span_id", "parent_id",
                 "pid", "tid", "args")

    def __init__(self, name, cat, t0, trace_id, span_id, parent_id, pid,
                 tid, args):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.pid = pid
        self.tid = tid
        self.args = args


class Tracer:
    """Thread-safe bounded span collector.

    Three entry styles, chosen by what the call site can know:

      * ``begin()`` / ``end()`` — spans opened and closed by the SAME
        logical operation (possibly on different threads; the span id is
        the handle). Unclosed spans stay visible in ``open_spans()`` —
        the trace gate fails on any.
      * ``add_complete()`` — retrospective spans synthesized from stamps
        that already exist (``QueryRequest.submit_t`` / ``dispatch_t``,
        ``QueryTask.submit_t`` / ``done_t``): no cross-thread open-span
        bookkeeping, no chance of a leak.
      * ``instant()`` — point events (steals, quarantines).

    ``created`` counts every span/instant ever allocated — the
    zero-overhead-when-disabled guard: a round served with tracing off
    must leave it unchanged.
    """

    def __init__(self, max_spans: int = 8192, flight_window: int = 128,
                 max_dumps: int = 64):
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=max_spans)
        self._open: Dict[int, _OpenSpan] = {}
        self._next_id = 0
        self.flight_window = flight_window
        self.flight = FlightRecorder(max_dumps)
        self.created = 0              # spans+instants allocated, ever
        self.dropped = 0              # ring evictions

    # -- recording ----------------------------------------------------------
    def begin(self, name: str, cat: str, *, trace_id: int = -1,
              parent_id: int = -1, pid: str = "service",
              tid: Optional[str] = None, **args) -> int:
        t0 = time.monotonic()
        tid = tid or threading.current_thread().name
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._open[sid] = _OpenSpan(name, cat, t0, trace_id, sid,
                                        parent_id, pid, tid,
                                        tuple(args.items()))
        return sid

    def end(self, span_id: int, **args) -> Optional[Span]:
        t1 = time.monotonic()
        with self._lock:
            op = self._open.pop(span_id, None)
            if op is None:
                return None
            span = Span(op.name, op.cat, op.t0, max(0.0, t1 - op.t0),
                        op.trace_id, op.span_id, op.parent_id, op.pid,
                        op.tid, op.args + tuple(args.items()))
            self._append_locked(span)
        return span

    def add_complete(self, name: str, cat: str, t0: float, t1: float, *,
                     trace_id: int = -1, parent_id: int = -1,
                     pid: str = "service", tid: Optional[str] = None,
                     **args) -> Span:
        """Record a retrospective span from existing monotonic stamps."""
        tid = tid or threading.current_thread().name
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            span = Span(name, cat, t0, max(0.0, t1 - t0), trace_id, sid,
                        parent_id, pid, tid, tuple(args.items()))
            self._append_locked(span)
        return span

    def instant(self, name: str, cat: str, *, trace_id: int = -1,
                pid: str = "service", tid: Optional[str] = None,
                **args) -> Span:
        now = time.monotonic()
        tid = tid or threading.current_thread().name
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            span = Span(name, cat, now, 0.0, trace_id, sid, -1, pid, tid,
                        tuple(args.items()))
            self._append_locked(span)
        return span

    def _append_locked(self, span: Span) -> None:
        if len(self._spans) == self._spans.maxlen:
            self.dropped += 1
        self._spans.append(span)
        self.created += 1

    # -- flight recorder ----------------------------------------------------
    def flight_dump(self, reason: str, **args) -> FlightDump:
        """Snapshot the recent span window (finished ring tail + every
        still-open span, rendered open-ended) as a postmortem artifact."""
        now = time.monotonic()
        with self._lock:
            recent = list(self._spans)[-self.flight_window:]
            for op in self._open.values():
                recent.append(Span(op.name, op.cat, op.t0,
                                   max(0.0, now - op.t0), op.trace_id,
                                   op.span_id, op.parent_id, op.pid, op.tid,
                                   op.args + (("open", True),)))
        dump = FlightDump(reason, now, dict(args), recent)
        self.flight.add(dump)
        return dump

    # -- lookups ------------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def open_spans(self) -> List[_OpenSpan]:
        with self._lock:
            return list(self._open.values())

    def trace(self) -> "Trace":
        return Trace(self.spans())

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open.clear()
            self.dropped = 0
        self.flight.clear()


# ---------------------------------------------------------------------------
# export: chrome trace events + text timeline
# ---------------------------------------------------------------------------
class Trace:
    """An immutable snapshot of spans with the two export renderings."""

    def __init__(self, spans: List[Span]):
        self.spans = sorted(spans, key=lambda s: (s.t0, s.span_id))

    def phase_names(self) -> List[str]:
        return sorted({s.name for s in self.spans})

    def lanes(self) -> List[Tuple[str, str]]:
        return sorted({(s.pid, s.tid) for s in self.spans})

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (load in perfetto / chrome://tracing).

        pid/tid labels (pool / worker names) become small integers with
        ``ph:"M"`` process_name / thread_name metadata naming the lanes;
        timestamps are microseconds relative to the earliest span."""
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}
        events: List[Dict[str, Any]] = []
        base = self.spans[0].t0 if self.spans else 0.0
        for s in self.spans:
            if s.pid not in pids:
                pids[s.pid] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pids[s.pid], "tid": 0,
                               "args": {"name": s.pid}})
            lane = (s.pid, s.tid)
            if lane not in tids:
                tids[lane] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pids[s.pid], "tid": tids[lane],
                               "args": {"name": s.tid}})
            args = {k: v for k, v in s.args}
            if s.trace_id >= 0:
                args["trace_id"] = s.trace_id
            ev = {"name": s.name, "cat": s.cat,
                  "ph": "i" if s.instant else "X",
                  "ts": round((s.t0 - base) * 1e6, 3),
                  "pid": pids[s.pid], "tid": tids[lane], "args": args}
            if s.instant:
                ev["s"] = "t"          # thread-scoped instant
            else:
                ev["dur"] = round(s.dur * 1e6, 3)
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def render_timeline(self, width: int = 40) -> str:
        """Deterministic text timeline: one row per span (start order),
        a bar over a [first span start, last span end] axis, and the
        lane + name + relative times. Deterministic for fixed span
        inputs, so golden-snapshotable (tests/fixtures/
        trace_timeline.txt)."""
        if not self.spans:
            return "trace: empty"
        t_lo = min(s.t0 for s in self.spans)
        t_hi = max(s.t1 for s in self.spans)
        extent = max(t_hi - t_lo, 1e-9)
        lane_w = max(len(f"{s.pid}/{s.tid}") for s in self.spans)
        name_w = max(len(s.name) for s in self.spans)
        lines = [f"trace {len(self.spans)} spans "
                 f"{len(self.lanes())} lanes "
                 f"span={extent * 1e3:.2f}ms"]
        for s in self.spans:
            lo = int((s.t0 - t_lo) / extent * width)
            hi = int((s.t1 - t_lo) / extent * width)
            lo = min(lo, width - 1)
            hi = min(max(hi, lo + 1), width)
            bar = "." * lo + ("|" if s.instant else "#" * (hi - lo))
            bar = bar.ljust(width, ".")
            rid = f" req={s.trace_id}" if s.trace_id >= 0 else ""
            lines.append(
                f"[{bar}] {f'{s.pid}/{s.tid}':<{lane_w}} "
                f"{s.name:<{name_w}} "
                f"{(s.t0 - t_lo) * 1e3:8.2f}ms "
                f"+{s.dur * 1e3:.2f}ms{rid}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the process tracer
# ---------------------------------------------------------------------------
_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER
