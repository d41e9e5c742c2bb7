"""Request-scoped tracing: the port of ``repro.analytics.tracing``.

Telemetry (analytics/telemetry.py) answers "where do the ROWS go"; this
module answers "where does the TIME go". Every span carries a trace id
(the request id, or -1 outside a request) and its parent span's id. The
port records these spans, by category (``cat``):

  plan       plan.compile (plan-cache miss: lowering + building the
             callable), plan.execute (one CompiledPlan dispatch: the
             host's dispatch of the plan's work; the spans below nest in it)
  queue      queue.wait (admission to dequeue)
  batcher    batch.group
  service    dispatch.build, retry.backoff, result.deliver
  scheduler  morsel.run, merge.partials; instants morsel.steal and
             pool.quarantine
  op         one span a W1-W4 operator call (median_direct, count_direct,
             count_partitioned, hash_join, index_join) and its phases:
             median.sort, median.counts, median.select; count.partition,
             count.aggregate; hash_join.layout (side=build|probe),
             hash_join.probe; index.build, index.probe (kind=...). The
             phases sit in the helpers the planner's executor shares
             (``columnar``, ``hashing``), so served queries record them too
  sync       sync:<site>, around each read of a device value that the
             W1-W4 path makes, explicit or inside a torch call: the host
             waits there until the device's queue drains. ``syncs=`` counts
             the reads when one call makes several (``torch.bincount`` on
             a CUDA tensor reads its input's minimum and maximum)

and flight dumps (``FlightRecorder``) named fault.build_fail,
fault.wait_poison, fault.pool_kill, overload.shed, pool.quarantine and
worker.leak. ``Tracer.created`` counts the spans and instants allocated,
``Tracer.dropped`` those the rings evicted before a reader drained them.

Discipline, as in ``telemetry.StatsRegistry``:

  * one module-level flag (``enable_tracing`` / ``disable_tracing`` /
    the ``tracing()`` context manager); every instrumentation site is
    behind it. Disabled (the default), a site makes ONE flag read and
    allocates no span: ``span()`` and ``scope()`` return one shared no-op
    object (``Tracer.created`` stays unchanged, so the zero-cost contract
    can be asserted);
  * the span rings are BOUNDED (``max_spans`` each) and thread-safe; a
    reader that ``drain()``s them before they fill loses nothing. The
    operators' ``op`` and ``sync`` spans have a ring of their own, so a
    traced plan walk neither evicts the serving tier's spans sooner nor
    fills a flight dump's window: a dump holds the serving spans alone;
  * spans are recorded on the host only, and never synchronize the
    device: the flag is NOT part of the plan-cache key, only telemetry's
    ``record`` flag changes what a plan runs.

One clock: every span stamps ``now()`` (``time.monotonic``). CUDA launches
are asynchronous, so a span around work on a card covers the host's
dispatch of that work, not its completion; a reader that stamps a marker
kernel on ``now()`` too puts the spans on the device trace's clock, where
a device idle gap that opens inside a sync span is a wait the read caused.

The open span and the trace id in force are held per thread (a
``contextvars.ContextVar``): ``span()`` nests under the innermost open
span and takes its trace id; ``scope(trace_id)`` sets the trace id for
everything opened under it, on the thread that opens it (the morsel
scheduler's workers open one around each morsel of a request).

Exports:

  * ``Trace.to_chrome_trace()``: Chrome trace-event JSON (perfetto
    loads it): ``ph:"X"`` complete events with pid/tid lanes per
    pool/worker plus ``ph:"M"`` metadata naming the lanes;
  * ``render_timeline()``: a deterministic text timeline (golden-
    snapshotted, as ``explain_analyze`` is);
  * ``FlightRecorder``: a bounded ring of postmortem dumps, the recent
    span window snapshotted at the moment a fault trips.

Standard library only and leaf-level: the kernels and the analytics
package import it (``repro_torch.analytics.tracing`` re-exports it),
never the reverse.
"""
from __future__ import annotations

import contextvars
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# The clock of every span of the port (and of the service's stamps that
# become spans).
now = time.monotonic

# The categories of the operators' spans, kept in a ring of their own.
_WORK = frozenset(("op", "sync"))

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
    t0: float                     # now() seconds
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
    at: float                     # now() of the trip
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

    Four entry styles, chosen by what the call site can know:

      * the module's ``span()`` — a block on one thread, nested under the
        span open there (the operators and syncs; the plan, the batcher,
        dispatch.build, retry.backoff, morsel.run). Open, it is listed
        in ``open_spans()`` as a ``begin()`` span is;
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
    must leave it unchanged. ``drain()`` hands the finished spans to a
    reader and empties the ring; ``dropped`` counts the spans it evicted
    first.
    """

    def __init__(self, max_spans: int = 8192, flight_window: int = 128,
                 max_dumps: int = 64):
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=max_spans)
        self._work: "deque[Span]" = deque(maxlen=max_spans)   # op, sync
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
        t0 = now()
        tid = tid or threading.current_thread().name
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._open[sid] = _OpenSpan(name, cat, t0, trace_id, sid,
                                        parent_id, pid, tid,
                                        tuple(args.items()))
        return sid

    def end(self, span_id: int, **args) -> Optional[Span]:
        t1 = now()
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
        """Record a retrospective span from existing ``now()`` stamps."""
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
        t = now()
        tid = tid or threading.current_thread().name
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            span = Span(name, cat, t, 0.0, trace_id, sid, -1, pid, tid,
                        tuple(args.items()))
            self._append_locked(span)
        return span

    def _append_locked(self, span: Span) -> None:
        ring = self._work if span.cat in _WORK else self._spans
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append(span)
        self.created += 1

    # -- flight recorder ----------------------------------------------------
    def flight_dump(self, reason: str, **args) -> FlightDump:
        """Snapshot the recent window of the serving spans (the tail of
        their ring + every still-open one, rendered open-ended) as a
        postmortem artifact; the operators' op and sync spans stay out."""
        t = now()
        with self._lock:
            recent = list(self._spans)[-self.flight_window:]
            for op in self._open.values():
                if op.cat in _WORK:
                    continue
                recent.append(Span(op.name, op.cat, op.t0,
                                   max(0.0, t - op.t0), op.trace_id,
                                   op.span_id, op.parent_id, op.pid, op.tid,
                                   op.args + (("open", True),)))
        dump = FlightDump(reason, t, dict(args), recent)
        self.flight.add(dump)
        return dump

    # -- lookups ------------------------------------------------------------
    def spans(self) -> List[Span]:
        """The finished spans: the serving ring's, then the operators'."""
        with self._lock:
            return list(self._spans) + list(self._work)

    def drain(self) -> List[Span]:
        """The finished spans, taken out of the rings. ``dropped`` keeps
        counting evictions, so a reader that drains before a ring fills
        (``max_spans``) loses nothing and can tell when it did."""
        with self._lock:
            out = list(self._spans) + list(self._work)
            self._spans.clear()
            self._work.clear()
        return out

    def open_spans(self) -> List[_OpenSpan]:
        with self._lock:
            return list(self._open.values())

    def trace(self) -> "Trace":
        return Trace(self.spans())

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._work.clear()
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


# ---------------------------------------------------------------------------
# spans opened where the work happens: span() and scope()
# ---------------------------------------------------------------------------
class _Frame:
    """What is open on this thread: the innermost span's id, name,
    category, lane and the args noted on it, under the trace id in
    force."""

    __slots__ = ("span_id", "name", "cat", "pid", "trace_id", "notes")

    def __init__(self, span_id: int, name: str, cat: str, pid: str,
                 trace_id: int, notes: Optional[Dict[str, Any]] = None):
        self.span_id = span_id
        self.name = name
        self.cat = cat
        self.pid = pid
        self.trace_id = trace_id
        self.notes = notes


_CURRENT: "contextvars.ContextVar[Optional[_Frame]]" = contextvars.ContextVar(
    "repro_torch_tracing_frame", default=None)


def current() -> Optional[_Frame]:
    """The innermost span open on this thread (a ``scope()`` shows as its
    enclosing span under the scope's trace id), or None."""
    return _CURRENT.get()


class _Off:
    """The one object ``span()`` and ``scope()`` return with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _LiveSpan:
    __slots__ = ("name", "cat", "pid", "args", "frame", "_token")

    def __init__(self, name: str, cat: str, pid: Optional[str], args):
        self.name, self.cat, self.pid, self.args = name, cat, pid, args

    def __enter__(self) -> _Frame:
        outer = _CURRENT.get()
        parent_id = outer.span_id if outer is not None else -1
        trace_id = outer.trace_id if outer is not None else -1
        pid = self.pid or (outer.pid if outer is not None else "op")
        sid = _TRACER.begin(self.name, self.cat, trace_id=trace_id,
                            parent_id=parent_id, pid=pid, **self.args)
        self.frame = _Frame(sid, self.name, self.cat, pid, trace_id, {})
        self._token = _CURRENT.set(self.frame)
        return self.frame

    def __exit__(self, exc_type, *exc) -> bool:
        _CURRENT.reset(self._token)
        notes = self.frame.notes
        if exc_type is not None:
            notes["error"] = exc_type.__name__
        _TRACER.end(self.frame.span_id, **notes)
        return False


def span(name: str, cat: str, *, pid: Optional[str] = None, **args):
    """A span around a block, recorded in the process tracer when the
    block ends (an exception ends it too, noted as ``error``). Its parent
    is the innermost span open on this thread, its trace id and lane
    (``pid``, unless given) the parent's; with none open, the scope's
    trace id and lane "op". With tracing off it returns one shared no-op
    object."""
    if not _ENABLED:
        return _OFF
    return _LiveSpan(name, cat, pid, args)


def note(**args) -> None:
    """Add ``args`` to the innermost span open on this thread, for what is
    known only inside its block. With tracing off, one flag read."""
    if not _ENABLED:
        return
    frame = _CURRENT.get()
    if frame is not None and frame.notes is not None:
        frame.notes.update(args)


class _Scope:
    __slots__ = ("trace_id", "_token")

    def __init__(self, trace_id: int):
        self.trace_id = trace_id

    def __enter__(self) -> _Frame:
        outer = _CURRENT.get()
        if outer is None:
            frame = _Frame(-1, "", "", "op", self.trace_id)
        else:
            frame = _Frame(outer.span_id, outer.name, outer.cat, outer.pid,
                           self.trace_id, outer.notes)
        self._token = _CURRENT.set(frame)
        return frame

    def __exit__(self, *exc) -> bool:
        _CURRENT.reset(self._token)
        return False


def scope(trace_id: int):
    """Set the trace id of every span opened under it on this thread.
    With tracing off, the shared no-op object."""
    if not _ENABLED:
        return _OFF
    return _Scope(trace_id)
