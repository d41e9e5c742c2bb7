"""Morsel-driven scheduler: socket-pinned worker pools + work stealing
(the port of ``repro.analytics.service.scheduler``).

The execution analog of the paper's thread-placement axis (Figs 3/4):

  * A **WorkerPool** is the NUMA-socket analog: it owns a CONTIGUOUS slice
    of the shard range and a small set of worker threads pinned to it. On
    a CUDA device each pool issues its work on a CUDA stream of its own
    (made at the first CUDA task), and each worker runs its morsels with
    that stream current; on the CPU, which runs only when the caller asks
    for it, a pool is just its threads.
  * A **morsel** is a contiguous row range of a scan (engine.morsel_slices),
    the work unit that makes load balancing possible at all. Plans whose
    root is a distributive Aggregate over a Scan/Filter/Project chain are
    split into per-morsel partial aggregations merged in morsel order
    (engine.merge_morsel_partials: the same bits under stealing).
    Join-probe pipelines the planner marked ``morsel_split`` take the
    SPLIT-PROBE path (_probe_split_decompose): the build sides run once
    per task, each worker pool probes against its OWN replica of the
    pooled build index (JoinIndexPool.replica, the paper's socket-local
    working set, built once per pool, never per morsel), and the
    per-morsel intermediate tables concatenate in morsel order, so the
    served result stays bit-identical to serial execution. Everything else
    (kernel joins, distributed contexts, sub-threshold probes) runs as one
    whole-plan morsel through the planner's CompiledPlan handle,
    bit-identical to a serial ``run_query`` by construction.
  * **ThreadPlacement** mirrors the reference's Fig 3/4 benchmark:
    OS_DEFAULT round-robins morsels over pools in arrival order, DENSE
    packs a query's morsels onto one pool, SPARSE stripes them across
    every pool.
  * **Work stealing** is the AutoNUMA / kernel-load-balancing analog: an
    idle pool steals from the longest backlog; every steal is counted.
  * **Fault tolerance**: workers stamp per-pool heartbeats and EWMA
    morsel-service times; a pool that dies (``kill_pool``) or straggles
    past ``straggler_threshold`` x its peers' median EWMA is QUARANTINED:
    its queued morsels are requeued onto surviving pools (``requeued``)
    and new dispatches avoid it. All fault hooks sit behind one
    ``if self.faults is not None`` check.

Handoffs between streams, which the reference's one implicit stream and
``jax.block_until_ready`` left implicit, are explicit here:

  * the tables (and a split-probe task's prelude and pooled base index)
    are made on the submitting thread's stream: ``submit`` records an
    event there, and a pool's stream waits on it before each morsel;
  * a morsel (and the merge after the last one) ends by synchronizing its
    pool's stream where the reference blocks until ready, so the EWMA and
    the straggler quarantine time the device's work, not the host's issue,
    and the merge reads finished partials;
  * ``QueryTask.wait()`` marks every result tensor as used on the
    waiter's current stream (``record_stream``), so the allocator does not
    hand the memory back to the producing pool's stream while the
    waiter's work may still read it; the morsels do the same for the
    prelude values they read;
  * a straggling pool's delay is host sleep for a CPU task and device
    work on the pool's stream for a CUDA task, so the quarantine is
    exercised by slow device work.
"""
from __future__ import annotations

import enum
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analytics import plan as L
from repro_torch.analytics import planner
from repro_torch.analytics import tracing
from repro_torch.analytics.columnar import (Table, finalize_stacked,
                                            stacked_columns)
from repro_torch.analytics.engine import (merge_morsel_partials,
                                          morsel_group_sums,
                                          morsel_slice_columns, morsel_slices)
from repro_torch.analytics.planner import ExecutionContext


class ThreadPlacement(enum.Enum):
    """Pool-to-work affinity strategies (the Fig 3/4 axis).

    OS_DEFAULT  arrival-order round-robin, no affinity (the "OS free to
                migrate" baseline — MeshLayout.NONE's serving analog).
    DENSE       a query's morsels packed onto ONE pool: contiguous shard
                slice, minimal cross-pool hops (Fig 4's dense pinning).
    SPARSE      a query's morsels striped across ALL pools: maximal
                aggregate bandwidth per query (Fig 3/4's sparse pinning).
    """

    OS_DEFAULT = "os_default"
    DENSE = "dense"
    SPARSE = "sparse"


# Distributed (virtual-mesh) plans are dispatched by one thread at a time,
# as in the reference, where concurrent shard_map dispatch could interleave
# per-device enqueue order and deadlock the collectives. A distributed plan
# owns the WHOLE mesh anyway: serializing its dispatch loses no
# parallelism; pools keep overlapping single-device work freely.
_MESH_DISPATCH_LOCK = threading.Lock()


def _on_cuda(device: Optional[torch.device]) -> bool:
    return device is not None and device.type == "cuda"


def _block(device: Optional[torch.device]) -> None:
    """The port's ``block_until_ready``: wait for the work this thread
    issued on its current stream of ``device`` (nothing to wait for on the
    CPU)."""
    if _on_cuda(device):
        torch.cuda.current_stream(device).synchronize()


def _used_here(values) -> None:
    """Mark every CUDA tensor in ``values`` (a tensor, or dicts, tuples and
    lists of them) as used on the current stream, so the caching allocator
    reuses its memory only after this stream's queued work is done."""
    if isinstance(values, torch.Tensor):
        if values.is_cuda:
            values.record_stream(torch.cuda.current_stream(values.device))
    elif isinstance(values, dict):
        for v in values.values():
            _used_here(v)
    elif isinstance(values, (tuple, list)):
        for v in values:
            _used_here(v)


@dataclass
class _Morsel:
    task: "QueryTask"
    seq: int                      # position in the task's morsel order
    lo: int
    length: int
    home_pool: int = -1           # assigned pool (stamped at dispatch)


class QueryTask:
    """One dispatch: a whole plan or a set of morsel partial-aggregations.

    ``wait()`` blocks until every morsel completed and the merged result
    is available. Exceptions raised by any morsel are captured and
    re-raised to the waiter."""

    def __init__(self, compiled: Optional[planner.CompiledPlan], tables,
                 morsel_fn: Optional[Callable] = None,
                 finalize: Optional[Callable] = None,
                 morsels: Optional[List[Tuple[int, int]]] = None):
        self.compiled = compiled            # None iff morsel-decomposed
        self.tables = tables
        self.device = planner._device_of(tables)
        # recorded by MorselScheduler.submit on the submitting thread's
        # stream after the task's inputs were made (CUDA tasks only)
        self.ready: Optional[torch.cuda.Event] = None
        self.morsel_fn = morsel_fn          # (tables, lo, length) -> partial
        self.finalize = finalize            # (sums, overflow) -> result dict
        self._partials: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._poison: Optional[BaseException] = None
        self.fault_ordinal: Optional[int] = None
        self.result: Optional[Dict[str, torch.Tensor]] = None
        self.submit_t: float = 0.0          # scheduler.submit stamp
        self.merge_t: float = 0.0           # last morsel done, merge begins
        self.done_t: float = 0.0            # completion stamp (monotonic)
        self.trace_id: int = -1             # owning request id (service)
        if morsel_fn is None:
            self.morsels = [_Morsel(self, 0, 0, 0)]
        else:
            self.morsels = [_Morsel(self, i, lo, hi - lo)
                            for i, (lo, hi) in enumerate(morsels)]
        self._pending = len(self.morsels)

    def poison(self, error: BaseException) -> None:
        """Fault-injection hook: the next morsel to run raises ``error``,
        so every ``wait()`` on this task raises (a deterministic stand-in
        for a dispatch that dies inside the executor)."""
        with self._lock:
            self._poison = error

    @property
    def split(self) -> bool:
        return self.morsel_fn is not None

    @property
    def physical(self):
        """The explicit physical plan a whole-plan task dispatches (the
        plan-cache value compile_plan resolved); None for morsel-split
        tasks, whose unit is the per-morsel partial executable."""
        return None if self.compiled is None else self.compiled.physical

    def _run_morsel(self, m: _Morsel, pool_id: int = 0) -> None:
        try:
            with self._lock:
                if self._poison is not None:
                    raise self._poison
            if self.morsel_fn is None:
                if self.compiled.ctx.n_shards is not None:
                    with _MESH_DISPATCH_LOCK:
                        out = self.compiled(self.tables)
                        _block(self.device)
                else:
                    out = self.compiled(self.tables)
                    _block(self.device)
                with self._lock:
                    self.result = out
            else:
                # the EXECUTING pool's id, not home_pool: a stolen morsel
                # must probe against the thief's build replica
                part = self.morsel_fn(self.tables, m.lo, length=m.length,
                                      pool=pool_id)
                _block(self.device)
                with self._lock:
                    self._partials[m.seq] = part
        except BaseException as e:  # noqa: BLE001 — surfaced to waiter
            with self._lock:
                self._error = e
        finally:
            with self._lock:
                self._pending -= 1
                last = self._pending == 0
            if last:
                self._finish()

    def _finish(self) -> None:
        # the merge phase begins when the LAST morsel lands — everything
        # between merge_t and done_t is morsel-order merge + finalize
        self.merge_t = time.monotonic()
        if self._error is None and self.morsel_fn is not None:
            try:
                # merge in MORSEL order, not completion order: the served
                # result must not depend on which pool finished first
                # (every partial's pool stream was synchronized when its
                # morsel ended, so this stream reads finished partials)
                sums, ovf = merge_morsel_partials(
                    [self._partials[i] for i in range(len(self.morsels))])
                self.result = self.finalize(sums, ovf)
                _block(self.device)
            except BaseException as e:  # noqa: BLE001
                self._error = e
        # stamp completion HERE, not when a waiter gets around to joining:
        # per-query latency must not include time spent waiting on other
        # tasks in the drain loop
        self.done_t = time.monotonic()
        if tracing.tracing_enabled() and self.morsel_fn is not None:
            tracing.tracer().add_complete(
                "merge.partials", "scheduler", self.merge_t, self.done_t,
                trace_id=self.trace_id, n_morsels=len(self.morsels))
        self._done.set()

    def wait(self, timeout: Optional[float] = None
             ) -> Dict[str, torch.Tensor]:
        if not self._done.wait(timeout):
            raise TimeoutError("query task did not complete in time")
        if self._error is not None:
            raise self._error
        # the result was made on a pool's stream and is read on the
        # waiter's: keep its memory from that pool's allocator until the
        # waiter's current stream is past it
        _used_here(self.result)
        return self.result


@dataclass
class WorkerPool:
    """The NUMA-socket analog: a contiguous shard slice + pinned workers,
    and on a CUDA device a stream of its own (``streams``, one per device
    the pool has run a task on, made by ``MorselScheduler.submit``)."""

    pool_id: int
    shard_lo: int                 # [shard_lo, shard_hi) of the device mesh
    shard_hi: int
    executed: int = 0             # morsels run by this pool's workers
    steals: int = 0               # morsels this pool stole from another
    queue: deque = field(default_factory=deque, repr=False)
    # fault-tolerance state (mutated under the scheduler's condition)
    dead: bool = False            # killed: workers exited, no new work
    quarantined: bool = False     # straggler/hang: avoided by dispatch
    heartbeat_t: float = 0.0      # last worker take/finish (monotonic)
    inflight: int = 0             # morsels currently executing
    ewma_s: float = 0.0           # EWMA morsel service time (ft.py idiom)
    samples: int = 0
    streams: Dict[torch.device, "torch.cuda.Stream"] = field(
        default_factory=dict, repr=False)

    @property
    def live(self) -> bool:
        return not (self.dead or self.quarantined)


class WorkerLeakError(RuntimeError):
    """close() could not join every worker thread — a wedged pool would
    otherwise leak threads invisibly across tests/sessions."""

    def __init__(self, unjoined: List[str]):
        super().__init__(f"unjoined worker threads after close(): "
                         f"{', '.join(unjoined)}")
        self.unjoined = list(unjoined)


@dataclass
class SchedulerStats:
    morsels_dispatched: int = 0
    tasks: int = 0
    executed_per_pool: Tuple[int, ...] = ()
    steals_per_pool: Tuple[int, ...] = ()
    requeued: int = 0             # morsels moved off dead/quarantined pools
    dead_pools: Tuple[int, ...] = ()
    quarantined_pools: Tuple[int, ...] = ()   # includes dead pools
    pool_ewma_s: Tuple[float, ...] = ()

    @property
    def steals(self) -> int:
        return sum(self.steals_per_pool)


class MorselScheduler:
    """Dispatch QueryTasks to socket-pinned pools under a ThreadPlacement.

    ``submit(task)`` enqueues the task's morsels per the placement policy
    and returns immediately; ``task.wait()`` joins. Pools steal from the
    longest backlog when their own deque runs dry (counted). The
    scheduler can be constructed ``started=False`` so tests can stage a
    backlog before any worker runs."""

    def __init__(self, n_pools: int = 2, workers_per_pool: int = 2,
                 placement: ThreadPlacement = ThreadPlacement.OS_DEFAULT,
                 morsel_rows: Optional[int] = None, steal: bool = True,
                 n_shards: Optional[int] = None, started: bool = True,
                 faults=None, straggler_threshold: float = 4.0,
                 straggler_warmup: int = 3, hang_after_s: float = 30.0):
        if n_pools < 1 or workers_per_pool < 1:
            raise ValueError("need at least one pool and one worker")
        self.placement = placement
        self.morsel_rows = morsel_rows
        self.steal = steal
        self.faults = faults                # ServiceFaultInjector | None
        self.straggler_threshold = straggler_threshold
        self.straggler_warmup = straggler_warmup
        self.hang_after_s = hang_after_s
        # the tables lie on one device: the pools share its one shard
        # unless the caller names a shard range to split
        shards = 1 if n_shards is None else n_shards
        per = max(1, shards // n_pools)
        now = time.monotonic()
        self.pools = [WorkerPool(i, min(i * per, shards),
                                 min((i + 1) * per, shards) if i < n_pools - 1
                                 else shards, heartbeat_t=now)
                      for i in range(n_pools)]
        self._cv = threading.Condition()
        self._rr = 0                        # OS_DEFAULT round-robin cursor
        self._sparse_base = 0               # SPARSE per-task stripe offset
        self._tasks = 0
        self._dispatched = 0
        self._requeued = 0
        self._closed = False
        self._threads: List[threading.Thread] = []
        self._workers_per_pool = workers_per_pool
        self._cycles_per_s: Dict[torch.device, float] = {}
        if started:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._threads:
            return
        now = time.monotonic()
        for pool in self.pools:
            pool.heartbeat_t = now
            for w in range(self._workers_per_pool):
                t = threading.Thread(
                    target=self._worker, args=(pool,),
                    name=f"pool{pool.pool_id}-w{w}", daemon=True)
                t.start()
                self._threads.append(t)

    def close(self, timeout: float = 5.0) -> List[str]:
        """Stop workers, drain, join. Returns the names of worker threads
        that did NOT join within ``timeout`` — a wedged pool must be a
        visible report, never a silent daemon-thread leak (the facade
        raises WorkerLeakError on a non-empty report)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        unjoined: List[str] = []
        for t in self._threads:
            t.join(timeout=timeout)
            if t.is_alive():
                unjoined.append(t.name)
        self._threads = []
        return unjoined

    def __enter__(self) -> "MorselScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- task construction --------------------------------------------------
    def build_task(self, plan: L.LogicalPlan, tables,
                   ctx: Optional[ExecutionContext] = None) -> QueryTask:
        """Compile (through the plan cache) and wrap a plan as a task.

        Decomposable plans (distributive Aggregate over a Scan chain, no
        mesh) become per-morsel partials when ``morsel_rows`` is set;
        planner-marked join-probe pipelines become split-probe tasks
        (build sides once per task, probe morsels per pool — see the
        module docstring); all others become a single whole-plan morsel
        whose result is bit-identical to serial execution by
        construction. Whole-plan dispatch goes through
        ``planner.compile_plan`` and therefore the EXPLICIT physical plan
        (lowered once, cached as the plan-cache value; inspectable via
        ``task.physical``) — the scheduler never re-derives strategy
        decisions at dispatch time. The whole-plan executable is only
        compiled on that fallback path — a split task must not push a
        never-invoked entry into the bounded plan cache."""
        ctx = ctx or ExecutionContext()
        # fault hook: one dispatch ordinal per build attempt (retries
        # re-tick); an injected build failure raises HERE, before any
        # compile work, exactly like a plan naming a missing table
        ordinal = (self.faults.begin_dispatch()
                   if self.faults is not None else None)
        if self.morsel_rows is not None and ctx.n_shards is None:
            split = (_morsel_decompose(plan, tables, ctx)
                     or _probe_split_decompose(plan, tables, ctx))
            if split is not None:
                morsel_fn, finalize, n_rows = split
                task = QueryTask(None, tables, morsel_fn, finalize,
                                 morsel_slices(n_rows, self.morsel_rows))
                task.fault_ordinal = ordinal
                return task
        task = QueryTask(planner.compile_plan(plan, tables, ctx), tables)
        task.fault_ordinal = ordinal
        return task

    # -- dispatch -----------------------------------------------------------
    def _live_pools(self) -> List[WorkerPool]:
        """Call under the condition: pools eligible for new work."""
        return [p for p in self.pools if p.live]

    def submit(self, task: QueryTask) -> QueryTask:
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            live = self._live_pools()
            if not live:
                raise RuntimeError("no live worker pools — every pool is "
                                   "dead or quarantined")
            self._tasks += 1
            task.submit_t = time.monotonic()
            if _on_cuda(task.device):
                # the task's inputs were made on this thread's stream: the
                # pools' streams wait on this event before its morsels
                task.ready = torch.cuda.Event()
                task.ready.record(torch.cuda.current_stream(task.device))
                for p in self.pools:
                    if task.device not in p.streams:
                        p.streams[task.device] = torch.cuda.Stream(
                            task.device)
            dense_pool = min(live, key=lambda p: len(p.queue)).pool_id
            # SPARSE stripes a task's morsels across every live pool,
            # starting from a per-task rotating base — otherwise
            # single-morsel (whole-plan) tasks would all land on pool 0
            # (seq is always 0) and the other pools could only work via
            # steals
            sparse_base = self._sparse_base
            self._sparse_base += 1
            for m in task.morsels:
                if self.placement == ThreadPlacement.DENSE:
                    m.home_pool = dense_pool
                elif self.placement == ThreadPlacement.SPARSE:
                    m.home_pool = live[(sparse_base + m.seq)
                                       % len(live)].pool_id
                else:                       # OS_DEFAULT: arrival order
                    m.home_pool = live[self._rr % len(live)].pool_id
                    self._rr += 1
                self.pools[m.home_pool].queue.append(m)
                self._dispatched += 1
            self._cv.notify_all()
        # fault hook AFTER enqueue: a pool kill scheduled at this ordinal
        # fires mid-round — the task's morsels may sit on the killed
        # pool's queue until check_pools() requeues them
        if self.faults is not None and task.fault_ordinal is not None:
            self.faults.on_submit(task.fault_ordinal, task, self)
        return task

    # -- fault tolerance ----------------------------------------------------
    def kill_pool(self, pool_id: int) -> None:
        """Drill analog of losing a socket/host: the pool's workers exit
        (in-flight morsels finish — threads cannot be preempted — but no
        new morsel is taken) and its backlog waits for check_pools() to
        requeue it onto survivors."""
        with self._cv:
            self.pools[pool_id].dead = True
            self._cv.notify_all()

    def quarantine_pool(self, pool_id: int) -> None:
        """Mark a pool unschedulable and requeue its backlog (manual
        override of the straggler/hang detectors)."""
        with self._cv:
            pool = self.pools[pool_id]
            if sum(p.live for p in self.pools) > 1 or not pool.live:
                pool.quarantined = True
            self._requeue_locked()
            self._cv.notify_all()

    def _requeue_locked(self) -> None:
        """Move every morsel queued on a non-live pool onto live pools,
        round-robin, preserving order (call under the condition)."""
        moved: List[_Morsel] = []
        for p in self.pools:
            if not p.live and p.queue:
                moved.extend(p.queue)
                p.queue.clear()
        if not moved:
            return
        live = self._live_pools()
        if not live:                 # nothing to requeue onto; put back
            self.pools[moved[0].home_pool].queue.extend(moved)
            return
        for i, m in enumerate(moved):
            target = live[i % len(live)]
            m.home_pool = target.pool_id
            target.queue.append(m)
        self._requeued += len(moved)

    def check_pools(self, now: Optional[float] = None) -> List[int]:
        """Heartbeat + EWMA sweep (the serving port of ft.py's
        StragglerDetector): quarantine pools that are dead, hung (backlog
        but no heartbeat within ``hang_after_s``), or straggling (EWMA
        morsel time > ``straggler_threshold`` x the live-pool median),
        then requeue their backlogs onto survivors. Never quarantines the
        last live pool. Returns newly quarantined pool ids."""
        now = time.monotonic() if now is None else now
        newly: List[int] = []
        with self._cv:
            for p in self.pools:
                if not p.live:
                    continue
                if sum(q.live for q in self.pools) <= 1:
                    break
                if p.dead:
                    continue
                if p.queue and now - p.heartbeat_t > self.hang_after_s:
                    p.quarantined = True
                    newly.append(p.pool_id)
            ready = [p for p in self.pools
                     if p.live and p.samples >= self.straggler_warmup]
            if len(ready) >= 2:
                for p in ready:
                    if sum(q.live for q in self.pools) <= 1:
                        break
                    # median of the PEERS, not the whole fleet: with few
                    # pools a fleet median that includes the straggler is
                    # dragged up by it (2 pools: median == mean, and the
                    # threshold could mathematically never trip)
                    med = float(np.median([q.ewma_s for q in ready
                                           if q is not p]))
                    if med > 0 and p.ewma_s > self.straggler_threshold * med:
                        p.quarantined = True
                        newly.append(p.pool_id)
            self._requeue_locked()
            if newly:
                self._cv.notify_all()
        if newly and tracing.tracing_enabled():
            tr = tracing.tracer()
            for pid in newly:
                tr.instant("pool.quarantine", "scheduler",
                           pid=f"pool{pid}")
            tr.flight_dump("pool.quarantine", pools=list(newly))
        return newly

    def run(self, plan: L.LogicalPlan, tables,
            ctx: Optional[ExecutionContext] = None
            ) -> Dict[str, torch.Tensor]:
        """Convenience: build, submit, wait."""
        return self.submit(self.build_task(plan, tables, ctx)).wait()

    # -- workers ------------------------------------------------------------
    def _take(self, pool: WorkerPool) -> Optional[_Morsel]:
        """Called under the lock: own head first, else steal the tail of
        the longest LIVE backlog (classic work stealing). A dead pool
        takes nothing (its workers are exiting); a quarantined pool only
        drains its own queue — a straggler must not slow other pools'
        work by stealing it."""
        if pool.dead:
            return None
        if pool.queue:
            return pool.queue.popleft()
        if not self.steal or pool.quarantined:
            return None
        victim = max((p for p in self.pools if p is not pool and p.live),
                     key=lambda p: len(p.queue), default=None)
        if victim is not None and victim.queue:
            pool.steals += 1
            m = victim.queue.pop()
            if tracing.tracing_enabled():
                tracing.tracer().instant(
                    "morsel.steal", "scheduler", trace_id=m.task.trace_id,
                    pid=f"pool{pool.pool_id}", victim=victim.pool_id,
                    seq=m.seq)
            return m
        return None

    def _worker(self, pool: WorkerPool) -> None:
        while True:
            with self._cv:
                m = self._take(pool)
                while m is None and not self._closed and not pool.dead:
                    self._cv.wait(timeout=0.1)
                    m = self._take(pool)
                if m is None:               # closed and drained, or killed
                    return
                pool.executed += 1
                pool.inflight += 1
                pool.heartbeat_t = time.monotonic()
            delay = (self.faults.morsel_delay(pool.pool_id)
                     if self.faults is not None else 0.0)
            dev = m.task.device
            host_delay = delay if not _on_cuda(dev) else 0.0
            if host_delay > 0.0:
                time.sleep(host_delay)
            t0 = time.monotonic()
            if _on_cuda(dev):
                stream = pool.streams[dev]
                # the stream context is thread-local: each worker sets it
                with torch.cuda.stream(stream):
                    stream.wait_event(m.task.ready)
                    if delay > 0.0:
                        self._device_delay(dev, delay)
                    m.task._run_morsel(m, pool.pool_id)
                    # a morsel that raised (a poisoned task) still waits
                    # for what its pool queued, the straggle too: the
                    # EWMA counts the delay, as the host sleep always is
                    stream.synchronize()
            else:
                m.task._run_morsel(m, pool.pool_id)
            t1 = time.monotonic()
            if tracing.tracing_enabled():
                tracing.tracer().add_complete(
                    "morsel.run", "scheduler", t0, t1,
                    trace_id=m.task.trace_id, pid=f"pool{pool.pool_id}",
                    seq=m.seq, rows=m.length)
            dt = t1 - t0 + host_delay           # EWMA must see the straggle
            with self._cv:
                pool.inflight -= 1
                pool.heartbeat_t = time.monotonic()
                pool.samples += 1
                pool.ewma_s = (dt if pool.samples == 1
                               else 0.3 * dt + 0.7 * pool.ewma_s)

    def _device_delay(self, device: torch.device, seconds: float) -> None:
        """Spend about ``seconds`` as device work on the current stream: a
        spin kernel of as many SM cycles, their rate measured once per
        device (the SM clock moves with load, so the delay is near, not
        exact)."""
        rate = self._cycles_per_s.get(device)
        if rate is None:
            probe = 1 << 24
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(probe)
            end.record()
            end.synchronize()
            rate = probe / (start.elapsed_time(end) / 1e3)
            self._cycles_per_s[device] = rate
        torch.cuda._sleep(int(seconds * rate))

    def stats(self) -> SchedulerStats:
        with self._cv:
            return SchedulerStats(
                morsels_dispatched=self._dispatched, tasks=self._tasks,
                executed_per_pool=tuple(p.executed for p in self.pools),
                steals_per_pool=tuple(p.steals for p in self.pools),
                requeued=self._requeued,
                dead_pools=tuple(p.pool_id for p in self.pools if p.dead),
                quarantined_pools=tuple(p.pool_id for p in self.pools
                                        if not p.live),
                pool_ewma_s=tuple(p.ewma_s for p in self.pools))


# ---------------------------------------------------------------------------
# morsel decomposition of distributive-aggregate plans
# ---------------------------------------------------------------------------
_DISTRIBUTIVE = ("sum", "avg", "count")


def _scan_chain(root: L.Node) -> Optional[Tuple[L.Scan, List[L.Node]]]:
    """(scan, [transforms leaf->root]) when root's child chain is pure
    Scan/Filter/Project; None otherwise."""
    chain: List[L.Node] = []
    node = root
    while True:
        if isinstance(node, L.Scan):
            return node, list(reversed(chain))
        if isinstance(node, (L.Filter, L.Project)):
            chain.append(node)
            node = node.child
            continue
        return None


def _morsel_decompose(plan: L.LogicalPlan, tables, ctx: ExecutionContext):
    """(morsel_fn, finalize, n_rows) for a decomposable plan, else None.

    Decomposable = root Aggregate whose aggregates are all distributive
    sums (sum/avg/count) over a Scan/Filter/Project chain. The morsel
    partial is the stacked (n_groups, C) sums table over one row range —
    the same physical primitive the planner lowers Aggregates onto — so
    merged morsel results reuse finalize_stacked and can never drift from
    the planner's semantics. NOTE: per-morsel partial sums merge in morsel
    order, which is a DIFFERENT float summation order than the one-pass
    serial plan — the split path trades bit-identity for intra-query
    parallelism (the whole-plan path keeps bit-identity). The morsel is a
    ``narrow`` view of the scan's columns at a Python-int offset."""
    root = plan.root
    if not isinstance(root, L.Aggregate):
        return None
    if any(op not in _DISTRIBUTIVE for _, (op, _c) in root.aggs):
        return None
    chain = _scan_chain(root.child)
    if chain is None:
        return None
    scan_node, transforms = chain
    # snapshot the cost profile ONCE: it keys the cache and is baked into
    # the cached closure (same stale-constants hazard as compile_plan)
    profile = planner.current_cost_profile()
    n_rows = next(iter(tables[scan_node.table].values())).shape[0]
    if root.key is None:
        n_groups = 1
    elif isinstance(root.n_groups, L.TableRows):
        n_groups = next(iter(
            tables[root.n_groups.table].values())).shape[0]
    else:
        n_groups = int(root.n_groups)
    aggs = dict(root.aggs)

    def partial(tbls, lo, *, length):
        t = Table(morsel_slice_columns(tbls[scan_node.table], lo, length))
        for node in transforms:
            if isinstance(node, L.Filter):
                t = t.filter(planner.eval_expr(node.pred, t))
            else:
                t = t.with_columns(**{n: planner.eval_expr(e, t)
                                      for n, e in node.cols})
        if root.key is None:
            t = t.with_columns(_g0=torch.zeros((length,), dtype=torch.int32,
                                               device=t.device))
            key = "_g0"
        else:
            key = root.key
        keys, vals, src = stacked_columns(t, key, n_groups, aggs)
        layout = planner.choose_aggregate(length, n_groups, vals.shape[1],
                                          ctx.executor, profile)
        return morsel_group_sums(keys, vals, n_groups, layout=layout,
                                 mode=ctx.mode,
                                 n_partitions=ctx.n_partitions,
                                 capacity_factor=ctx.capacity_factor)

    # one callable per (plan, ctx, signature, profile) in the plan cache
    fn = planner.cached_executable(
        ("morsel", plan, ctx.cache_key(), planner.table_signature(tables),
         profile),
        lambda: partial)

    def morsel_fn(tbls, lo, *, length, pool=0):
        del pool             # partial sums need no pool-local structures
        return fn(tbls, lo, length=length)

    src = [c for _, (op, c) in root.aggs
           if op in ("sum", "avg")]
    src = list(dict.fromkeys(src))          # distinct, insertion order

    def finalize(sums, overflow):
        out = finalize_stacked(aggs, src, sums, _no_order_stats)
        out["_overflow"] = overflow.to(torch.int32)
        if plan.outputs is not None:
            out = {k: out[k] for k in plan.outputs}
        return out

    return morsel_fn, finalize, n_rows


def _no_order_stats(op, col):
    raise ValueError(f"order statistic {op!r} is not distributive — "
                     "plan should not have been morsel-decomposed")


# ---------------------------------------------------------------------------
# split-probe decomposition of planner-marked join pipelines
# ---------------------------------------------------------------------------
def _build_probe_split(plan: L.LogicalPlan, ctx: ExecutionContext, tables,
                       profile):
    """Plan-cache value for a split-probe candidate: the string "whole"
    when the planner declines (cached, so repeat dispatches skip the
    re-analysis), else (probe_split, run_prelude, run_morsel, run_final).

    Three callables because the three phases run at different cadences:
    the prelude (join build sides, Attach sources) once per TASK, the
    probe pipeline once per MORSEL, and the finalize (aggregate + TopK
    over the merged intermediate table) once per task after the
    morsel-order merge. The finalize walks no table, so its executor is
    placed on the tables' device explicitly."""
    phys = planner.lower(plan, ctx,
                         {t: next(iter(c.values())).shape[0]
                          for t, c in tables.items()}, profile)
    split = planner.probe_split(phys)
    if split is None:
        return "whole"
    preludes = split.preludes
    device = planner._device_of(tables)

    def run_prelude(tbls, indexes):
        ex = planner._LocalExecutor(tbls, ctx, indexes, profile)
        vals = []
        for p in preludes:
            v = ex.run(p.node)
            # Tables pass to the morsels as (columns, mask): each morsel
            # re-seeds index_cache from its pool's replica instead
            vals.append((v.columns, v.mask) if p.is_table else v)
        return vals, ex.overflow

    def run_morsel(tbls, prelude_vals, replicas, lo, *, length):
        # the prelude was made on the submitting thread's stream and is
        # read on this pool's: keep its memory until this stream is past it
        _used_here(prelude_vals)
        ex = planner._LocalExecutor(tbls, ctx, {}, profile)
        ri = 0
        for p, v in zip(preludes, prelude_vals):
            if p.is_table:
                cols, mask = v
                cache = {}
                if p.index is not None:
                    # the pool-local build replica seeds key_index, so a
                    # sorted join never re-argsorts inside a morsel
                    cache = {p.index[1]: replicas[ri]}
                    ri += 1
                ex._memo[p.node] = Table(dict(cols), mask, cache)
            else:
                ex._memo[p.node] = v
        ex._memo[split.scan] = Table(
            morsel_slice_columns(tbls[split.scan.table], lo, length))
        t = ex.run(split.pipeline_root)
        return (t.columns, t.mask), ex.overflow

    def run_final(merged, overflow):
        cols, mask = merged
        ex = planner._LocalExecutor({}, ctx, {}, profile, device=device)
        ex._memo[split.pipeline_root] = Table(dict(cols), mask)
        ex.overflow = ex.overflow + overflow
        out = dict(ex.run(split.root))
        out["_overflow"] = ex.overflow
        if split.outputs is not None:
            out = {k: out[k] for k in split.outputs}
        return out

    return split, run_prelude, run_morsel, run_final


def _probe_split_decompose(plan: L.LogicalPlan, tables,
                           ctx: ExecutionContext):
    """(morsel_fn, finalize, n_rows) for a planner-marked split-probe
    join pipeline, else None.

    The division of labor mirrors the paper's socket-local working sets:
    the build side is materialized ONCE per task (prelude), its pooled
    sort index replicated ONCE per worker pool
    (JoinIndexPool.replica), and every probe morsel — wherever stealing
    lands it — probes the executing pool's replica. Per-morsel outputs
    are row slices of the serial intermediate table, so the morsel-order
    concat + finalize reproduces serial ``run_query`` bit-for-bit (the
    distributive-aggregate path cannot promise that; this path can,
    because the merge is a concat, not a float re-ordering)."""
    profile = planner.current_cost_profile()
    bundle = planner.cached_executable(
        ("morsel-probe", plan, ctx.cache_key(),
         planner.table_signature(tables), profile),
        lambda: _build_probe_split(plan, ctx, tables, profile))
    if bundle == "whole":
        return None
    split, run_prelude, run_morsel, run_final = bundle
    join_pool = planner.join_index_pool()
    indexes = {f"{t}.{c}": join_pool.get(t, c, tables[t][c])
               for t, c in planner.required_indexes(plan.root)}
    # the prelude runs ONCE per task — its values are closed over by
    # every morsel of this task
    prelude_vals, prelude_ovf = run_prelude(tables, indexes)
    specs = [p.index for p in split.preludes if p.index is not None]

    def morsel_fn(tbls, lo, *, length, pool=0):
        # per-POOL build replicas (an LRU hit after each pool's first
        # morsel), fetched by the EXECUTING pool — including on steals
        replicas = [join_pool.replica(t, c, tbls[t][c], pool)
                    for t, c in specs]
        return run_morsel(tbls, prelude_vals, replicas, lo, length=length)

    def finalize(merged, overflow):
        return run_final(merged, overflow + prelude_ovf)

    return morsel_fn, finalize, split.n_rows
