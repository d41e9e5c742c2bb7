"""Concurrent query-serving subsystem over the cost-based planner: the
port of ``repro.analytics.service``.

The paper's biggest wins come from *placement of work* — thread placement
(Figs 3/4), kernel load balancing, and memory placement (Fig 5) decide
whether memory-intensive operators run near their data. This package is
the serving layer where those effects compound under concurrency:

    submit() -> AdmissionQueue -> QueryBatcher -> MorselScheduler -> pools

  queue.py      bounded admission with priority classes, weighted-fair
                dequeue, deadlines, and overload shedding
  batcher.py    multi-query batching by plan-cache key (structurally
                identical queries execute as one dispatch) + the
                adaptive per-round batching window
  scheduler.py  morsel-driven scheduling onto socket-pinned worker pools;
                ThreadPlacement (OS_DEFAULT/DENSE/SPARSE) controls
                pool-to-shard affinity, work stealing is the AutoNUMA /
                kernel-load-balancing analog (steals counted); pool
                heartbeats, straggler quarantine, and morsel requeue; on
                a CUDA device each pool issues on a stream of its own
  faults.py     deterministic fault injection (build failures, wait
                poison, pool kills, stragglers) behind zero-cost hooks
  retry.py      bounded-attempt exponential backoff with deterministic
                jitter, deadline-aware across attempts
  service.py    the AnalyticsService facade: submit()/drain(), the
                always-on background serve loop (start()/stop()),
                retry/recovery, per-class SLO stats, ServiceStats
"""
from repro_torch.analytics.service.batcher import (AdaptiveBatchWindow,
                                                   BatchStats, QueryBatcher)
from repro_torch.analytics.service.faults import (InjectedServiceFault,
                                                  ServiceFaultInjector)
from repro_torch.analytics.service.queue import (AdmissionQueue,
                                                 QueryRequest, QueueStats)
from repro_torch.analytics.service.retry import RetryPolicy
from repro_torch.analytics.service.scheduler import (MorselScheduler,
                                                     SchedulerStats,
                                                     ThreadPlacement,
                                                     WorkerLeakError,
                                                     WorkerPool)
from repro_torch.analytics.service.service import (AnalyticsService,
                                                   ClassStats, QueryResult,
                                                   ServiceConfig,
                                                   ServiceStats)

__all__ = [
    "AdaptiveBatchWindow", "AdmissionQueue", "AnalyticsService",
    "BatchStats", "ClassStats", "InjectedServiceFault", "MorselScheduler",
    "QueryBatcher", "QueryRequest", "QueryResult", "QueueStats",
    "RetryPolicy", "SchedulerStats", "ServiceConfig", "ServiceFaultInjector",
    "ServiceStats", "ThreadPlacement", "WorkerLeakError", "WorkerPool",
]
