"""Admission queue: bounded, priority-classed, weighted-fair intake (the
port of ``repro.analytics.service.queue``).

The serving layer's first placement decision is *whether work enters at
all*: a bounded queue turns overload into explicit backpressure
(``offer`` returning False) instead of unbounded memory growth, and
deadline checks at dispatch time shed requests that already missed their
budget while queued — the two levers the paper's co-running-queries
problem (Awan et al.) needs before any placement tuning can help.

Graceful degradation adds two more levers on top of plain backpressure:

  * **Priority classes** (``QueryRequest.priority``, higher = more
    important) order dequeue strictly: an interactive class is served
    before a batch class. Within a class, dequeue is weighted-fair
    round-robin across ``client_id`` — a flooding client cannot starve
    its peers, and a client's weight buys it proportionally more slots
    per turn.
  * **Overload shedding**: when depth crosses ``shed_watermark``, an
    incoming request evicts the newest LOWEST-priority queued request of
    a class strictly below its own (lowest-priority-first shedding); an
    incoming request that is itself the lowest class is rejected
    (backpressure). Victims are handed back via ``pop_overload_shed`` so
    the service reports a terminal result instead of dropping silently.

Every counter is taken under the queue lock, so ``stats()`` snapshots are
race-free, and they CONSERVE exactly:

    admitted == dequeued + expired + shed_overload + depth
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.analytics import tracing
from repro_torch.analytics.plan import LogicalPlan
from repro_torch.analytics.planner import ExecutionContext


@dataclass
class QueryRequest:
    """One client query: a logical plan + a tables reference + a budget.

    ``tables`` is a {table: {column: array}} mapping — held by reference,
    never copied; structurally identical requests over the SAME mapping
    are deduplicated into one dispatch by the batcher. ``deadline_s`` is
    an absolute ``tracing.now()`` point; None = no deadline.
    ``priority`` is the service class (higher = more important; dequeued
    first, shed last)."""

    req_id: int
    plan: LogicalPlan
    tables: Mapping[str, Mapping[str, Any]]
    context: ExecutionContext
    deadline_s: Optional[float] = None
    client_id: int = 0
    priority: int = 1
    submit_t: float = 0.0          # stamped by the queue at admission
    dispatch_t: float = 0.0        # stamped by the service at dispatch

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s


@dataclass
class QueueStats:
    submitted: int = 0             # offers seen (admitted + rejected)
    admitted: int = 0
    rejected_full: int = 0         # backpressure: queue at max depth
    expired: int = 0               # missed deadline while queued
    dequeued: int = 0              # live requests handed to the service
    shed_overload: int = 0         # evicted lowest-priority-first
    depth: int = 0                 # current
    max_depth_seen: int = 0
    queue_wait_total_s: float = 0.0  # summed over dequeued requests
    by_class: Dict[int, Dict[str, int]] = field(default_factory=dict)

    def copy(self) -> "QueueStats":
        d = dict(self.__dict__)
        d["by_class"] = {p: dict(c) for p, c in self.by_class.items()}
        return QueueStats(**d)


class _ClassBucket:
    """One priority class: per-client FIFOs + a round-robin client ring."""

    def __init__(self) -> None:
        self.clients: Dict[int, deque] = {}
        self.ring: "deque[int]" = deque()     # client_ids, RR order
        self.depth = 0

    def push(self, req: QueryRequest) -> None:
        q = self.clients.get(req.client_id)
        if q is None:
            q = self.clients[req.client_id] = deque()
            self.ring.append(req.client_id)
        q.append(req)
        self.depth += 1

    def pop_newest(self) -> QueryRequest:
        """Evict the newest request of the client with the deepest FIFO
        (shed the flooder's freshest work first)."""
        cid = max(self.clients, key=lambda c: len(self.clients[c]))
        req = self.clients[cid].pop()
        self._gc(cid)
        return req

    def _gc(self, cid: int) -> None:
        self.depth -= 1
        if not self.clients[cid]:
            del self.clients[cid]
            self.ring.remove(cid)


class AdmissionQueue:
    """Bounded priority queue with race-free, exactly-conserving stats."""

    def __init__(self, max_depth: int = 256,
                 shed_watermark: Optional[int] = None,
                 client_weights: Optional[Mapping[int, int]] = None):
        if max_depth < 1:
            raise ValueError("queue needs max_depth >= 1")
        if shed_watermark is not None and shed_watermark < 1:
            raise ValueError("shed_watermark must be >= 1")
        self.max_depth = max_depth
        self.shed_watermark = shed_watermark
        self.client_weights = dict(client_weights or {})
        self._buckets: Dict[int, _ClassBucket] = {}
        self._depth = 0
        self._overload_shed: List[QueryRequest] = []
        self._lock = threading.Lock()
        self._stats = QueueStats()

    def __len__(self) -> int:
        with self._lock:
            return self._depth

    # -- internals (call under self._lock) ----------------------------------
    def _cls(self, priority: int) -> Dict[str, int]:
        return self._stats.by_class.setdefault(
            priority, {"admitted": 0, "dequeued": 0, "expired": 0,
                       "shed": 0, "rejected": 0})

    def _push(self, req: QueryRequest) -> None:
        b = self._buckets.get(req.priority)
        if b is None:
            b = self._buckets[req.priority] = _ClassBucket()
        b.push(req)
        self._depth += 1

    def _shed_lowest_below(self, priority: int) -> Optional[QueryRequest]:
        """Evict from the lowest non-empty class strictly below ``priority``."""
        for p in sorted(self._buckets):
            if p >= priority:
                return None
            b = self._buckets[p]
            if b.depth:
                victim = b.pop_newest()
                self._depth -= 1
                if not b.depth:
                    del self._buckets[p]
                return victim
        return None

    # -- producer side ------------------------------------------------------
    def offer(self, req: QueryRequest,
              now: Optional[float] = None) -> bool:
        """Admit a request; False = rejected (backpressure). Crossing the
        shed watermark evicts a strictly-lower-priority victim instead of
        rejecting a high-priority arrival — collect victims via
        ``pop_overload_shed``."""
        now = tracing.now() if now is None else now
        with self._lock:
            self._stats.submitted += 1
            limit = self.max_depth
            if self.shed_watermark is not None:
                limit = min(limit, self.shed_watermark)
            if self._depth >= limit:
                victim = (self._shed_lowest_below(req.priority)
                          if self.shed_watermark is not None else None)
                if victim is None:
                    self._stats.rejected_full += 1
                    self._cls(req.priority)["rejected"] += 1
                    return False
                self._stats.shed_overload += 1
                self._cls(victim.priority)["shed"] += 1
                self._overload_shed.append(victim)
            req.submit_t = now
            self._push(req)
            self._stats.admitted += 1
            self._cls(req.priority)["admitted"] += 1
            self._stats.depth = self._depth
            self._stats.max_depth_seen = max(self._stats.max_depth_seen,
                                             self._depth)
            return True

    # -- consumer side ------------------------------------------------------
    def take_batch(self, max_n: int, now: Optional[float] = None
                   ) -> "tuple[List[QueryRequest], List[QueryRequest]]":
        """Dequeue up to ``max_n`` live requests: strict priority order
        across classes, weighted-fair round-robin across clients within a
        class, FIFO per client.

        Returns (live, expired): requests whose deadline passed while
        queued are shed — counted, and handed back so the serving loop can
        report their fate to the submitter instead of dropping silently."""
        now = tracing.now() if now is None else now
        out: List[QueryRequest] = []
        shed: List[QueryRequest] = []
        with self._lock:
            for p in sorted(self._buckets, reverse=True):
                b = self._buckets.get(p)
                if b is None:
                    continue
                while b.depth and len(out) < max_n:
                    cid = b.ring[0]
                    quota = max(1, self.client_weights.get(cid, 1))
                    q = b.clients[cid]
                    while q and quota > 0 and len(out) < max_n:
                        req = q.popleft()
                        self._depth -= 1
                        self._stats.queue_wait_total_s += now - req.submit_t
                        if tracing.tracing_enabled():
                            # retrospective: the wait is only known at
                            # dequeue, when both stamps exist
                            tracing.tracer().add_complete(
                                "queue.wait", "queue", req.submit_t, now,
                                trace_id=req.req_id, cls=req.priority,
                                expired=req.expired(now))
                        if req.expired(now):
                            self._stats.expired += 1
                            self._cls(req.priority)["expired"] += 1
                            shed.append(req)
                            continue
                        req.dispatch_t = now
                        out.append(req)
                        self._stats.dequeued += 1
                        self._cls(req.priority)["dequeued"] += 1
                        quota -= 1
                    if not q:
                        del b.clients[cid]
                        b.ring.popleft()
                    else:
                        b.ring.rotate(-1)
                    b.depth = sum(len(d) for d in b.clients.values())
                    if not b.depth:
                        del self._buckets[p]
                        break
                if len(out) >= max_n:
                    break
            self._stats.depth = self._depth
        return out, shed

    def shed_expired(self, now: Optional[float] = None
                     ) -> List[QueryRequest]:
        """Sweep and remove every queued request whose deadline has
        passed — called between serving rounds so a request that expired
        while an earlier round was being served is shed promptly (counted
        in ``expired``) instead of waiting to be dequeued late."""
        now = tracing.now() if now is None else now
        shed: List[QueryRequest] = []
        with self._lock:
            for p in list(self._buckets):
                b = self._buckets[p]
                for cid in list(b.clients):
                    q = b.clients[cid]
                    live = deque(r for r in q if not r.expired(now))
                    n = len(q) - len(live)
                    if n:
                        for r in q:
                            if r.expired(now):
                                shed.append(r)
                                self._stats.expired += 1
                                self._cls(r.priority)["expired"] += 1
                                self._stats.queue_wait_total_s += (
                                    now - r.submit_t)
                                if tracing.tracing_enabled():
                                    tracing.tracer().add_complete(
                                        "queue.wait", "queue",
                                        r.submit_t, now,
                                        trace_id=r.req_id,
                                        cls=r.priority, expired=True)
                        b.clients[cid] = live
                        b.depth -= n
                        self._depth -= n
                        if not live:
                            del b.clients[cid]
                            b.ring.remove(cid)
                if not b.depth:
                    del self._buckets[p]
            self._stats.depth = self._depth
        return shed

    def pop_overload_shed(self) -> List[QueryRequest]:
        """Hand back (and clear) requests evicted by overload shedding."""
        with self._lock:
            out, self._overload_shed = self._overload_shed, []
            return out

    def stats(self) -> QueueStats:
        with self._lock:
            return self._stats.copy()
