"""AnalyticsService: the fault-tolerant concurrent query-serving facade
(the port of ``repro.analytics.service.service``).

    service = AnalyticsService(ServiceConfig(...))
    service.start()                             # background drain loop
    rid = service.submit(plan, tables, priority=2)   # None => backpressured
    res = service.result(rid, timeout=5.0)      # or service.drain()
    service.stats()                             # ServiceStats snapshot
    service.stop(); service.close()

``submit`` is non-blocking admission into the bounded priority queue.
Serving runs in one of two modes:

  * **submit-then-drain** (the original mode): ``drain()`` pulls batches
    until the entry backlog is served;
  * **always-on** (``start()``): a background drain thread serves rounds
    continuously — admission happens DURING service — with an adaptive
    batching window (grow ``max_batch`` under backlog for QPS, shrink
    when idle for p99; see batcher.AdaptiveBatchWindow).

Each round groups requests by plan-cache key (batcher), dispatches one
task per distinct (plan, context, signature, tables) through the morsel
scheduler's socket-pinned pools, and fans shared results out. Failed or
hung dispatches are retried under ``ServiceConfig.retry`` (exponential
backoff, deterministic jitter, per-request deadline respected across
attempts); the scheduler's heartbeat/EWMA sweep quarantines dead or
straggling pools between wait ticks and requeues their backlog, so the
service keeps serving on a shrunk pool set. Results stay bit-identical
to serial execution because whole-plan dispatch is idempotent and morsel
partials merge in morsel order regardless of which pool ran them — on
the split-probe path (scheduler._probe_split_decompose: join probe
morsels over pool-replicated build sides) the merge is a morsel-order
row CONCATENATION feeding one finalize, so no reduction is ever
reassociated and re-dispatch after a fault reproduces the serial answer
bit-for-bit.

Every admitted request gets EXACTLY ONE terminal ``QueryResult``: a
value, ``expired`` (deadline passed — at dequeue, between rounds, or
mid-flight), ``shed`` (evicted lowest-priority-first under overload), or
an exhausted-retries error. Per-class SLO attainment (deadline-met
fraction, retries, shed counts) is reported in ``ServiceStats.per_class``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.analytics import telemetry
from repro_torch.analytics import tracing
from repro_torch.analytics.plan import LogicalPlan
from repro_torch.analytics.planner import ExecutionContext
from repro_torch.analytics.service.batcher import (AdaptiveBatchWindow,
                                                   QueryBatcher)
from repro_torch.analytics.service.faults import ServiceFaultInjector
from repro_torch.analytics.service.queue import AdmissionQueue, QueryRequest
from repro_torch.analytics.service.retry import RetryPolicy
from repro_torch.analytics.service.scheduler import (MorselScheduler,
                                                     ThreadPlacement,
                                                     WorkerLeakError)


@dataclass(frozen=True)
class ServiceConfig:
    n_pools: int = 2
    workers_per_pool: int = 2
    queue_depth: int = 256
    max_batch: int = 64            # requests pulled per drain round (cap)
    min_batch: int = 1             # adaptive-window floor (serve loop)
    morsel_rows: Optional[int] = None   # None = whole-plan (bit-identical)
    placement: ThreadPlacement = ThreadPlacement.OS_DEFAULT
    batching: bool = True
    steal: bool = True
    # -- graceful degradation ------------------------------------------------
    # depth at which offers start evicting lower-priority queued requests
    # (None = plain backpressure only, the pre-fault-tolerance behavior)
    shed_watermark: Optional[int] = None
    client_weights: Optional[Mapping[int, int]] = None
    # -- fault tolerance -----------------------------------------------------
    retry: Optional[RetryPolicy] = RetryPolicy()
    faults: Optional[ServiceFaultInjector] = None
    hang_timeout_s: Optional[float] = 60.0  # per-attempt wait budget
    wait_tick_s: float = 0.05      # heartbeat-check cadence while waiting
    straggler_threshold: float = 4.0
    straggler_warmup: int = 3
    hang_after_s: float = 30.0     # stale-heartbeat quarantine threshold
    idle_wait_s: float = 0.02      # serve-loop sleep when the queue is dry
    close_timeout_s: float = 5.0   # per-worker join budget in close()
    # latency/queue-wait histograms keep the most recent N samples: a
    # long-lived service must stay memory-bounded, and the percentiles
    # should reflect CURRENT tail behavior, not be diluted by hours of
    # old samples
    histogram_window: int = 8192


@dataclass
class QueryResult:
    req_id: int
    value: Optional[Dict[str, Any]]     # None => expired/shed/failed
    queue_wait_s: float = 0.0
    latency_s: float = 0.0
    batch_size: int = 1                 # requests served by this dispatch
    expired: bool = False               # deadline passed before a value
    shed: bool = False                  # evicted under overload
    attempts: int = 1                   # dispatch attempts consumed
    priority: int = 1
    error: Optional[str] = None         # terminal failure, per dispatch
    # latency attribution for completed requests: seconds per phase
    # (queue_wait / batch_wait / retry_backoff / execute / merge), built
    # from DISJOINT sub-intervals of [submit_t, done_t] so the sum can
    # never exceed latency_s; None for expired/shed/failed terminals
    phases: Optional[Dict[str, float]] = None


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return float(np.percentile(np.asarray(sorted_vals), q))


# latency-attribution phase names, in serving-path order
PHASES = ("queue_wait", "batch_wait", "retry_backoff", "execute", "merge")


def _phase_pcts(samples: List[Dict[str, float]],
                q: float) -> Dict[str, float]:
    """Per-phase percentile (ms) over a window of phase dicts."""
    out: Dict[str, float] = {}
    for name in PHASES:
        vals = [p[name] for p in samples if name in p]
        out[name] = _pct(vals, q) * 1e3 if vals else 0.0
    return out


@dataclass
class ClassStats:
    """Per-priority-class outcome counters + SLO attainment."""

    priority: int
    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    failed: int = 0
    expired: int = 0
    shed: int = 0
    retries: int = 0
    deadline_total: int = 0        # terminal requests that HAD a deadline
    deadline_met: int = 0          # ... that got a value within it
    # latency attribution (ms): phase -> percentile over this class's
    # completed requests, decomposing the end-to-end percentile into
    # queue_wait / batch_wait / retry_backoff / execute / merge
    phase_p50_ms: Dict[str, float] = field(default_factory=dict)
    phase_p95_ms: Dict[str, float] = field(default_factory=dict)
    phase_p99_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def slo_attainment(self) -> float:
        """Deadline-met fraction over requests that carried a deadline
        (1.0 when none did — nothing promised, nothing missed)."""
        if self.deadline_total == 0:
            return 1.0
        return self.deadline_met / self.deadline_total


@dataclass
class ServiceStats:
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    expired: int = 0
    shed: int = 0                  # overload-shed (lowest-priority-first)
    failed: int = 0
    completed: int = 0
    retries: int = 0               # extra dispatch attempts
    requeued: int = 0              # morsels moved off dead/straggler pools
    batches: int = 0
    dispatches: int = 0
    dedup_hits: int = 0
    morsels: int = 0
    steals: int = 0
    steals_per_pool: Tuple[int, ...] = ()
    dead_pools: Tuple[int, ...] = ()
    quarantined_pools: Tuple[int, ...] = ()
    batch_window: int = 0          # adaptive window (serve-loop mode)
    per_class: Dict[int, ClassStats] = field(default_factory=dict)
    qps: float = 0.0
    latency_p50_ms: float = 0.0
    latency_p95_ms: float = 0.0
    latency_p99_ms: float = 0.0
    queue_wait_p50_ms: float = 0.0
    queue_wait_p95_ms: float = 0.0
    queue_wait_p99_ms: float = 0.0
    # fleet-wide latency attribution (ms): where the pXX actually goes
    phase_p50_ms: Dict[str, float] = field(default_factory=dict)
    phase_p95_ms: Dict[str, float] = field(default_factory=dict)
    phase_p99_ms: Dict[str, float] = field(default_factory=dict)
    # execution-telemetry snapshot (the process-global StatsRegistry at
    # stats() time — all zero unless telemetry is enabled): plans with
    # recorded stats, recorded executions, plans currently outside the
    # drift band, and adaptive replans the planner performed on cache hits
    plans_tracked: int = 0
    telemetry_executions: int = 0
    drifting_plans: int = 0
    replans: int = 0

    def describe(self) -> str:
        return (f"completed={self.completed}/{self.submitted} "
                f"(rejected={self.rejected}, expired={self.expired}, "
                f"shed={self.shed}, failed={self.failed}) "
                f"dispatches={self.dispatches} dedup={self.dedup_hits} "
                f"retries={self.retries} requeued={self.requeued} "
                f"steals={self.steals} qps={self.qps:.1f} "
                f"p50={self.latency_p50_ms:.2f}ms "
                f"p99={self.latency_p99_ms:.2f}ms")


def _new_class_counts() -> Dict[str, int]:
    return {"completed": 0, "failed": 0, "expired_late": 0, "retries": 0,
            "deadline_total": 0, "deadline_met": 0}


class AnalyticsService:
    """Queue -> batcher -> scheduler -> pools, with retries + histograms."""

    def __init__(self, config: Optional[ServiceConfig] = None):
        self.config = config or ServiceConfig()
        self.queue = AdmissionQueue(
            self.config.queue_depth,
            shed_watermark=self.config.shed_watermark,
            client_weights=self.config.client_weights)
        self.batcher = QueryBatcher()
        self.scheduler = MorselScheduler(
            n_pools=self.config.n_pools,
            workers_per_pool=self.config.workers_per_pool,
            placement=self.config.placement,
            morsel_rows=self.config.morsel_rows,
            steal=self.config.steal,
            faults=self.config.faults,
            straggler_threshold=self.config.straggler_threshold,
            straggler_warmup=self.config.straggler_warmup,
            hang_after_s=self.config.hang_after_s)
        self._lock = threading.Lock()
        self._next_id = 0
        window = self.config.histogram_window
        self._latencies: "deque[float]" = deque(maxlen=window)
        self._waits: "deque[float]" = deque(maxlen=window)
        # latency-attribution windows: phase dicts for completed requests,
        # fleet-wide and per class (same bounded-window discipline)
        self._phases: "deque[Dict[str, float]]" = deque(maxlen=window)
        self._class_phases: Dict[int, deque] = {}
        self._completed = 0
        self._failed = 0
        self._expired_late = 0     # expired after dequeue (not queue-counted)
        self._retries = 0
        self._dispatches = 0       # tasks successfully submitted
        self._dedup_hits = 0       # requests served by a peer's dispatch
        self._classes: Dict[int, Dict[str, int]] = {}
        self._busy_s = 0.0         # union of active-serving time (no idle)
        self._active_drains = 0
        self._busy_start = 0.0
        # terminal results + pending-request tracking (always maintained;
        # the serve loop writes here, drain()/result() read)
        self._results: Dict[int, QueryResult] = {}
        self._pending: set = set()
        self._results_cv = threading.Condition(self._lock)
        self._window = self.config.max_batch
        # serve-loop lifecycle
        self._serve_thread: Optional[threading.Thread] = None
        self._stop_flag = False
        self._drain_on_stop = True
        self._wake = threading.Condition()

    # -- client side --------------------------------------------------------
    def submit(self, plan: LogicalPlan,
               tables: Mapping[str, Mapping[str, Any]], *,
               context: Optional[ExecutionContext] = None,
               deadline_s: Optional[float] = None,
               client_id: int = 0, priority: int = 1) -> Optional[int]:
        """Admit one query. Returns the request id, or None when the queue
        is full (backpressure — the caller decides whether to retry).
        ``deadline_s`` is RELATIVE seconds from now; ``priority`` is the
        service class (higher = dequeued first, shed last)."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        req = QueryRequest(
            req_id=rid, plan=plan, tables=tables,
            context=context or ExecutionContext(),
            deadline_s=(None if deadline_s is None
                        else time.monotonic() + deadline_s),
            client_id=client_id, priority=priority)
        if not self.queue.offer(req):
            return None
        with self._lock:
            self._pending.add(rid)
        # the offer may have evicted a lower-priority victim: give it its
        # terminal result immediately (the serve loop would also collect
        # it, but submit-then-drain mode must not leave it pending)
        self._collect_overload_shed(None)
        with self._wake:
            self._wake.notify_all()
        return rid

    def result(self, req_id: int,
               timeout: Optional[float] = None) -> Optional[QueryResult]:
        """Pop the terminal result for one request, waiting up to
        ``timeout`` seconds (None = forever). Returns None on timeout."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._results_cv:
            while req_id not in self._results:
                remaining = None if end is None else end - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._results_cv.wait(0.05 if remaining is None
                                      else min(0.05, remaining))
            return self._results.pop(req_id)

    def take_results(self) -> Dict[int, QueryResult]:
        """Pop every terminal result recorded so far."""
        with self._lock:
            out, self._results = self._results, {}
            return out

    # -- always-on serving --------------------------------------------------
    def start(self) -> "AnalyticsService":
        """Start the background drain loop: admission during service,
        adaptive batching window, continuous pool health checks."""
        with self._lock:
            if self._serve_thread is not None:
                return self
            self._stop_flag = False
            t = threading.Thread(target=self._serve_loop,
                                 name="svc-drain-loop", daemon=True)
            self._serve_thread = t
        t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the background loop. ``drain=True`` (default) serves the
        remaining backlog first so no admitted request is left pending."""
        with self._lock:
            t = self._serve_thread
        if t is None:
            return
        with self._wake:
            self._stop_flag = True
            self._drain_on_stop = drain
            self._wake.notify_all()
        t.join()
        with self._lock:
            self._serve_thread = None
            self._stop_flag = False

    @property
    def serving(self) -> bool:
        with self._lock:
            return self._serve_thread is not None

    def _serve_loop(self) -> None:
        window = AdaptiveBatchWindow(self.config.min_batch,
                                     self.config.max_batch)
        while True:
            self._collect_overload_shed(None)
            # deadline staleness: shed requests that expired while earlier
            # rounds were served, instead of dequeuing them late
            for req in self.queue.shed_expired():
                self._record(req, expired=True, out=None)
            reqs, shed = self.queue.take_batch(window.window)
            for req in shed:
                self._record(req, expired=True, out=None)
            if reqs:
                self._busy_enter()
                try:
                    self._serve_round(reqs, None)
                finally:
                    self._busy_exit()
                with self._lock:
                    self._window = window.observe(len(self.queue))
                self.scheduler.check_pools()
                continue
            self.scheduler.check_pools()
            with self._lock:
                self._window = window.observe(0)
            with self._wake:
                if self._stop_flag:
                    if self._drain_on_stop and len(self.queue) > 0:
                        continue
                    return
                if len(self.queue) == 0:
                    self._wake.wait(self.config.idle_wait_s)

    # -- submit-then-drain serving ------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> Dict[int, QueryResult]:
        """Serve everything queued AT ENTRY; returns per-request results.

        With the background loop running this instead WAITS until every
        admitted request has a terminal result (up to ``timeout``) and
        returns all results accumulated so far.

        Pull-based mode: each round takes up to ``max_batch`` requests,
        batches them, dispatches every (batch, tables-identity) group as
        one task, and waits for the round before pulling the next —
        queue-wait for later requests therefore includes earlier rounds'
        service time, exactly the open-loop backlog the p99 histogram
        should see. The backlog is SNAPSHOTTED at entry: requests
        admitted while this call is serving wait for the next drain, so a
        submitter keeping pace with the service can never pin drain() in
        an unbounded loop. Deadlines are re-checked after every round, so
        a request that expires while an earlier round is being served is
        shed (counted in ``expired``) instead of dispatched late."""
        if self.serving:
            end = None if timeout is None else time.monotonic() + timeout
            with self._results_cv:
                while self._pending:
                    if end is not None and time.monotonic() >= end:
                        break
                    self._results_cv.wait(0.05)
            return self.take_results()
        out: Dict[int, QueryResult] = {}
        self._busy_enter()
        try:
            self._drain_snapshot(out)
        finally:
            self._busy_exit()
        out.update(self.take_results())
        return out

    def _busy_enter(self) -> None:
        t = time.monotonic()
        with self._lock:
            if self._active_drains == 0:
                self._busy_start = t
            self._active_drains += 1

    def _busy_exit(self) -> None:
        with self._lock:
            self._active_drains -= 1
            if self._active_drains == 0:
                # busy time is the UNION of active-serving intervals:
                # overlapping drains must not double-count (qps would
                # be understated)
                self._busy_s += time.monotonic() - self._busy_start

    def _drain_snapshot(self, out: Dict[int, QueryResult]) -> None:
        remaining = len(self.queue)
        while remaining > 0:
            round_reqs, shed = self.queue.take_batch(
                min(self.config.max_batch, remaining))
            remaining -= len(round_reqs) + len(shed)
            for req in shed:
                self._record(req, expired=True, out=out)
            if not round_reqs:
                if shed:
                    continue        # whole round expired; keep draining
                break
            self._serve_round(round_reqs, out)
            # deadline staleness fix: requests that expired while THIS
            # round was being served are shed now, not dispatched late by
            # a later round
            for req in self.queue.shed_expired():
                remaining -= 1
                self._record(req, expired=True, out=out)
            for req in self.queue.pop_overload_shed():
                remaining -= 1
                self._record(req, shed=True, out=out)

    # -- one serving round --------------------------------------------------
    def _serve_round(self, round_reqs: List[QueryRequest],
                     out: Optional[Dict[int, QueryResult]]) -> None:
        # dispatch-time deadline re-check: take_batch's check can go stale
        # while the batch waits its turn behind other rounds
        now = time.monotonic()
        live = []
        for req in round_reqs:
            if req.expired(now):
                self._record(req, expired=True, late_expired=True, out=out)
            else:
                live.append(req)
        if not live:
            return
        if self.config.batching:
            batches = self.batcher.group(live)
            shares = [s for b in batches for s in b.shares]
        else:
            shares = [[r] for r in live]
        inflight = []
        for share in shares:
            # build/submit can raise eagerly (e.g. a plan naming a table
            # its mapping lacks, caught at morsel decompose, or an
            # injected build fault): that failure belongs to THIS share
            # only, never to the round's other requests — and is retried
            # under the policy before going terminal
            task, attempt, err, build_start, backoff = \
                self._dispatch_share(share)
            if task is None:
                self._fan_out(share, None, err, attempt, out)
            else:
                with self._lock:
                    # dedup counted once per share, at its FIRST
                    # successful submit — a share that never dispatched
                    # deduped nothing
                    self._dedup_hits += len(share) - 1
                inflight.append((task, share, attempt, build_start,
                                 backoff))
        for task, share, attempt, build_start, backoff in inflight:
            # fault isolation: one failing dispatch must not discard the
            # round's other results or poison co-submitted clients
            self._await_share(task, share, attempt, out, build_start,
                              backoff)

    def _share_deadline(self, share: List[QueryRequest]) -> Optional[float]:
        """The share keeps trying while ANY member can still benefit."""
        if any(r.deadline_s is None for r in share):
            return None
        return max(r.deadline_s for r in share)

    def _can_retry(self, attempt: int, deadline: Optional[float],
                   rep: QueryRequest) -> bool:
        policy = self.config.retry
        return (policy is not None
                and policy.should_retry(attempt, time.monotonic(),
                                        deadline, key=rep.req_id))

    def _count_retry(self, rep: QueryRequest) -> None:
        with self._lock:
            self._retries += 1
            self._class_counts(rep.priority)["retries"] += 1

    def _try_dispatch(self, rep: QueryRequest):
        """One build+submit attempt -> (task, None) | (None, error str)."""
        traced = tracing.tracing_enabled()
        t0 = time.monotonic() if traced else 0.0
        try:
            task = self.scheduler.build_task(rep.plan, rep.tables,
                                             rep.context)
            # thread the request id through the scheduler BEFORE submit:
            # morsel.run / steal / merge spans attribute to this request
            task.trace_id = rep.req_id
            self.scheduler.submit(task)
        except Exception as e:  # noqa: BLE001 — reported per share
            if traced:
                tracing.tracer().add_complete(
                    "dispatch.build", "service", t0, time.monotonic(),
                    trace_id=rep.req_id, error=type(e).__name__)
            return None, f"{type(e).__name__}: {e}"
        if traced:
            tracing.tracer().add_complete(
                "dispatch.build", "service", t0, time.monotonic(),
                trace_id=rep.req_id, morsels=len(task.morsels))
        with self._lock:
            self._dispatches += 1
        return task, None

    def _backoff(self, attempt: int, rep: QueryRequest) -> float:
        """Sleep the retry backoff; returns the slept seconds (the
        retry_backoff attribution phase) and records the span."""
        delay = self.config.retry.backoff_s(attempt, key=rep.req_id)
        if tracing.tracing_enabled():
            t0 = time.monotonic()
            time.sleep(delay)
            tracing.tracer().add_complete(
                "retry.backoff", "service", t0, time.monotonic(),
                trace_id=rep.req_id, attempt=attempt)
        else:
            time.sleep(delay)
        return delay

    def _dispatch_share(self, share: List[QueryRequest]):
        """Build+submit with retry/backoff.

        Returns (task|None, attempts, err, build_start, backoff_s):
        ``build_start`` is the monotonic stamp at which THIS share's
        first build attempt began (the end of its batch-wait phase) and
        ``backoff_s`` the backoff slept so far — both feed latency
        attribution."""
        rep = share[0]
        deadline = self._share_deadline(share)
        build_start = time.monotonic()
        backoff = 0.0
        attempt = 0
        while True:
            attempt += 1
            task, err = self._try_dispatch(rep)
            if task is not None:
                return task, attempt, None, build_start, backoff
            if not self._can_retry(attempt, deadline, rep):
                return None, attempt, err, build_start, backoff
            self._count_retry(rep)
            backoff += self._backoff(attempt, rep)

    def _await_share(self, task, share: List[QueryRequest], attempt: int,
                     out: Optional[Dict[int, QueryResult]],
                     build_start: float = 0.0,
                     backoff: float = 0.0) -> None:
        """Wait for a dispatched share; retry failed/hung dispatches under
        the policy (per-request deadline respected across attempts)."""
        rep = share[0]
        deadline = self._share_deadline(share)
        while True:
            error = None
            if task is not None:
                value, error, deadline_hit = self._await_task(task, deadline)
                if error is None:
                    self._fan_out(share, task, None, attempt, out,
                                  value=value, build_start=build_start,
                                  backoff=backoff)
                    return
                if deadline_hit:
                    # every member's deadline passed mid-flight (the share
                    # deadline is the max): expired, not failed
                    for req in share:
                        self._record(req, expired=True, late_expired=True,
                                     attempts=attempt,
                                     batch_size=len(share), out=out)
                    return
            if not self._can_retry(attempt, deadline, rep):
                self._fan_out(share, task, error, attempt, out)
                return
            self._count_retry(rep)
            backoff += self._backoff(attempt, rep)
            attempt += 1
            # re-dispatch: whole-plan tasks are idempotent (same compiled
            # executable, same inputs) and morsel partials merge in morsel
            # order — a retried dispatch returns the same result the
            # failed one would have
            task, error = self._try_dispatch(rep)

    def _await_task(self, task, deadline: Optional[float]):
        """Tick-wait on a task, sweeping pool health between ticks.

        Returns (value, None, False) on success; (None, err, False) on a
        retryable failure (exception or hang-budget timeout); (None, err,
        True) when the share's deadline passed while waiting."""
        start = time.monotonic()
        hang = self.config.hang_timeout_s
        while True:
            try:
                return task.wait(timeout=self.config.wait_tick_s), None, False
            except TimeoutError:
                # the tick path is where dead/straggler pools get noticed:
                # quarantine + requeue lets the SAME task finish on
                # surviving pools without burning a retry attempt
                self.scheduler.check_pools()
                now = time.monotonic()
                if deadline is not None and now > deadline:
                    return None, "deadline exceeded in flight", True
                if hang is not None and now - start > hang:
                    return (None, f"TimeoutError: dispatch exceeded "
                            f"hang budget {hang}s", False)
            except Exception as e:  # noqa: BLE001 — retried, then reported
                return None, f"{type(e).__name__}: {e}", False

    # -- terminal-result recording ------------------------------------------
    def _fan_out(self, share: List[QueryRequest], task, error: Optional[str],
                 attempts: int, out: Optional[Dict[int, QueryResult]],
                 value=None, build_start: float = 0.0,
                 backoff: float = 0.0) -> None:
        # latency uses the task's own completion stamp, not this loop's
        # join order (a fast query must not inherit a slow peer's
        # wait-loop position)
        done = (task.done_t if task is not None and task.done_t
                else time.monotonic())
        for req in share:
            phases = None
            if error is None and value is not None and task is not None \
                    and build_start and task.submit_t:
                # disjoint sub-intervals of [submit_t, done_t], so the sum
                # can never exceed the end-to-end wall:
                #   [submit, dequeue] [dequeue, build] (backoff sleeps)
                #   [sched submit, last morsel] [last morsel, merged]
                phases = {
                    "queue_wait": max(0.0, req.dispatch_t - req.submit_t)
                                  if req.dispatch_t else 0.0,
                    "batch_wait": max(0.0, build_start - req.dispatch_t)
                                  if req.dispatch_t else 0.0,
                    "retry_backoff": backoff,
                    "execute": max(0.0, task.merge_t - task.submit_t),
                    "merge": max(0.0, task.done_t - task.merge_t),
                }
            self._record(req, value=value, error=error, attempts=attempts,
                         batch_size=len(share), done=done, out=out,
                         phases=phases)

    def _class_counts(self, priority: int) -> Dict[str, int]:
        return self._classes.setdefault(priority, _new_class_counts())

    def _collect_overload_shed(
            self, out: Optional[Dict[int, QueryResult]]) -> None:
        for req in self.queue.pop_overload_shed():
            self._record(req, shed=True, out=out)

    def _record(self, req: QueryRequest, *, value=None,
                error: Optional[str] = None, expired: bool = False,
                shed: bool = False, late_expired: bool = False,
                attempts: int = 1, batch_size: int = 1,
                done: Optional[float] = None,
                out: Optional[Dict[int, QueryResult]] = None,
                phases: Optional[Dict[str, float]] = None) -> None:
        """The single terminal-result sink: stats, SLO, result store."""
        traced = tracing.tracing_enabled()
        done = time.monotonic() if done is None else done
        wait = ((req.dispatch_t if req.dispatch_t else done) - req.submit_t)
        res = QueryResult(
            req_id=req.req_id,
            # shallow-copy per client: deduplicated peers must not see
            # each other's in-place edits (the arrays inside are
            # immutable and stay shared)
            value=dict(value) if value is not None else None,
            queue_wait_s=max(0.0, wait),
            latency_s=max(0.0, done - req.submit_t),
            batch_size=batch_size, expired=expired, shed=shed,
            attempts=attempts, priority=req.priority, error=error,
            phases=phases)
        if traced:
            if shed:
                # graceful degradation tripped: leave a postmortem
                tracing.tracer().flight_dump(
                    "overload.shed", req=req.req_id, cls=req.priority)
            # delivery lag: task completion -> terminal result visible
            tracing.tracer().add_complete(
                "result.deliver", "service", done, time.monotonic(),
                trace_id=req.req_id,
                outcome=("error" if error is not None else
                         "expired" if expired else
                         "shed" if shed else "ok"))
        with self._lock:
            cls = self._class_counts(req.priority)
            if error is not None:
                self._failed += 1
                cls["failed"] += 1
            elif expired:
                if late_expired:
                    # queue-side sheds were already counted by the queue;
                    # post-dequeue expiries are ours to count
                    self._expired_late += 1
                    cls["expired_late"] += 1
            elif not shed:
                self._completed += 1
                cls["completed"] += 1
                self._latencies.append(res.latency_s)
                self._waits.append(res.queue_wait_s)
                if phases is not None:
                    self._phases.append(phases)
                    pw = self._class_phases.get(req.priority)
                    if pw is None:
                        pw = self._class_phases[req.priority] = deque(
                            maxlen=self.config.histogram_window)
                    pw.append(phases)
            if req.deadline_s is not None:
                cls["deadline_total"] += 1
                if error is None and not expired and not shed \
                        and done <= req.deadline_s:
                    cls["deadline_met"] += 1
            self._pending.discard(req.req_id)
            if out is None:
                self._results[req.req_id] = res
            self._results_cv.notify_all()
        if out is not None:
            out[req.req_id] = res

    # -- stats --------------------------------------------------------------
    def stats(self) -> ServiceStats:
        qs = self.queue.stats()
        bs = self.batcher.stats()
        ss = self.scheduler.stats()
        tsum = telemetry.registry().summary()
        with self._lock:
            lat = list(self._latencies)
            waits = list(self._waits)
            completed = self._completed
            failed = self._failed
            expired_late = self._expired_late
            retries = self._retries
            dispatches = self._dispatches
            dedup_hits = self._dedup_hits
            window = self._window
            classes = {p: dict(c) for p, c in self._classes.items()}
            phases = list(self._phases)
            class_phases = {p: list(w)
                            for p, w in self._class_phases.items()}
            busy = self._busy_s
            if self._active_drains > 0:   # include the in-progress round
                busy += time.monotonic() - self._busy_start
        per_class: Dict[int, ClassStats] = {}
        for p, c in qs.by_class.items():
            per_class[p] = ClassStats(
                priority=p, admitted=c["admitted"], rejected=c["rejected"],
                expired=c["expired"], shed=c["shed"])
        for p, c in classes.items():
            cs = per_class.setdefault(p, ClassStats(priority=p))
            cs.completed = c["completed"]
            cs.failed = c["failed"]
            cs.expired += c["expired_late"]
            cs.retries = c["retries"]
            cs.deadline_total = c["deadline_total"]
            cs.deadline_met = c["deadline_met"]
        for p, w in class_phases.items():
            cs = per_class.setdefault(p, ClassStats(priority=p))
            cs.phase_p50_ms = _phase_pcts(w, 50)
            cs.phase_p95_ms = _phase_pcts(w, 95)
            cs.phase_p99_ms = _phase_pcts(w, 99)
        return ServiceStats(
            submitted=qs.submitted, admitted=qs.admitted,
            rejected=qs.rejected_full, expired=qs.expired + expired_late,
            shed=qs.shed_overload, failed=failed, completed=completed,
            retries=retries, requeued=ss.requeued, batches=bs.batches,
            dispatches=dispatches, dedup_hits=dedup_hits,
            morsels=ss.morsels_dispatched, steals=ss.steals,
            steals_per_pool=ss.steals_per_pool,
            dead_pools=ss.dead_pools,
            quarantined_pools=ss.quarantined_pools,
            batch_window=window, per_class=per_class,
            qps=(completed / busy) if busy > 0 else 0.0,
            latency_p50_ms=_pct(lat, 50) * 1e3,
            latency_p95_ms=_pct(lat, 95) * 1e3,
            latency_p99_ms=_pct(lat, 99) * 1e3,
            queue_wait_p50_ms=_pct(waits, 50) * 1e3,
            queue_wait_p95_ms=_pct(waits, 95) * 1e3,
            queue_wait_p99_ms=_pct(waits, 99) * 1e3,
            phase_p50_ms=_phase_pcts(phases, 50),
            phase_p95_ms=_phase_pcts(phases, 95),
            phase_p99_ms=_phase_pcts(phases, 99),
            plans_tracked=tsum["plans_tracked"],
            telemetry_executions=tsum["executions"],
            drifting_plans=tsum["drifting_plans"],
            replans=tsum["replans"])

    # -- tracing ------------------------------------------------------------
    def export_trace(self, path: str) -> None:
        """Write the tracer's current span window as Chrome trace-event
        JSON (open in perfetto or chrome://tracing). Spans exist only for
        rounds served under ``tracing.tracing()`` / ``enable_tracing``."""
        tracing.tracer().trace().save(path)

    def flight_dumps(self):
        """The flight recorder's postmortem ring (fault trips, sheds,
        quarantines, worker leaks) — newest last."""
        return tracing.tracer().flight.dumps()

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop serving and join every worker; a wedged pool raises
        WorkerLeakError instead of leaking daemon threads invisibly."""
        self.stop()
        unjoined = self.scheduler.close(timeout=self.config.close_timeout_s)
        if unjoined:
            if tracing.tracing_enabled():
                tracing.tracer().flight_dump("worker.leak",
                                             unjoined=list(unjoined))
            raise WorkerLeakError(unjoined)

    def __enter__(self) -> "AnalyticsService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
