"""Multi-query batching: group admitted requests by plan-cache key (the
port of ``repro.analytics.service.batcher``).

Structurally identical queries — same logical plan, same ExecutionContext,
same table shape signature — resolve to the SAME plan-cache entry, so a
batch of them is one entry dispatched k times (no re-lowering) or, when
they also reference the same tables mapping, ONE dispatch whose result is
fanned out to every requester (the plan-cache-hot common case of a
dashboard fleet asking the same question). Accounting follows
runtime/serve_loop.ContinuousBatcher's style: a stats dataclass the
facade merges into ServiceStats.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.analytics import planner
from repro_torch.analytics import tracing
from repro_torch.analytics.service.queue import QueryRequest


@dataclass
class BatchStats:
    """Grouping-time counters only. Dispatch outcomes (dispatches issued,
    dedup hits) are counted by the service AFTER a share's task is
    successfully submitted — counting them here would report phantom
    dispatches for shares whose build/submit later fails."""

    batches: int = 0               # plan-cache-key groups formed
    batched_queries: int = 0       # requests that shared a group with >= 1 peer

    def copy(self) -> "BatchStats":
        return BatchStats(**self.__dict__)


@dataclass
class QueryBatch:
    """One plan-cache-key group; ``shares`` sub-groups requests by tables
    identity — each sub-group is a single dispatch fanned out to all of
    its members."""

    key: Tuple
    requests: List[QueryRequest] = field(default_factory=list)
    shares: List[List[QueryRequest]] = field(default_factory=list)


class AdaptiveBatchWindow:
    """Per-round batch-size controller for the always-on serve loop.

    Large rounds amortize grouping/dispatch overhead (QPS under backlog);
    small rounds keep queue-wait — and therefore p99 — low when traffic
    is light. The window doubles while the post-round backlog exceeds it
    (the queue is outrunning the service) and halves on an idle round,
    clamped to [min_batch, max_batch]. Multiplicative in both directions:
    it tracks load swings in O(log) rounds instead of creeping linearly."""

    def __init__(self, min_batch: int = 1, max_batch: int = 64):
        if not 1 <= min_batch <= max_batch:
            raise ValueError("need 1 <= min_batch <= max_batch")
        self.min_batch = min_batch
        self.max_batch = max_batch
        self.window = min_batch

    def observe(self, backlog: int) -> int:
        """Feed the post-round queue depth; returns the next window."""
        if backlog > self.window:
            self.window = min(self.max_batch, self.window * 2)
        elif backlog == 0:
            self.window = max(self.min_batch, self.window // 2)
        return self.window


class QueryBatcher:
    """Stateless grouping; stats accumulate across calls (mutated and
    snapshotted under a lock so a monitoring thread can never observe a
    torn BatchStats — the same race-free-stats guarantee every other
    component in the subsystem gives)."""

    def __init__(self) -> None:
        self._stats = BatchStats()
        self._lock = threading.Lock()

    def stats(self) -> BatchStats:
        with self._lock:
            return self._stats.copy()

    @staticmethod
    def batch_key(req: QueryRequest) -> Tuple:
        """The plan-cache key axis: (plan structure, context, shape
        signature) — deliberately the same triple planner.compile_plan
        caches on, so one batch == one executable."""
        return (req.plan, req.context.cache_key(),
                planner.table_signature(req.tables))

    def group(self, requests: List[QueryRequest]) -> List[QueryBatch]:
        t0 = time.monotonic() if tracing.tracing_enabled() else 0.0
        groups: Dict[Tuple, QueryBatch] = {}
        for req in requests:
            key = self.batch_key(req)
            if key not in groups:
                groups[key] = QueryBatch(key)
            groups[key].requests.append(req)
        with self._lock:
            for batch in groups.values():
                by_tables: Dict[int, List[QueryRequest]] = {}
                for req in batch.requests:
                    by_tables.setdefault(id(req.tables), []).append(req)
                batch.shares = list(by_tables.values())
                self._stats.batches += 1
                if len(batch.requests) > 1:
                    self._stats.batched_queries += len(batch.requests)
        if requests and t0 and tracing.tracing_enabled():
            tracing.tracer().add_complete(
                "batch.group", "batcher", t0, time.monotonic(),
                requests=len(requests), batches=len(groups))
        return list(groups.values())
