"""Deterministic fault injection for the serving tier: the port of
``repro.analytics.service.faults`` (the same schedule for the same seed).

The serving analog of the reference's ``runtime/ft.py`` FailureInjector:
every fault a production deployment sees — a dispatch whose build raises,
a task whose ``wait()`` poisons, a worker pool that dies mid-round, a pool
that straggles — is injectable on a fixed schedule (dispatch ordinals) or at a
seeded rate, so the recovery machinery (retry/backoff, pool quarantine,
morsel requeue, priority shedding) is exercised by tests and benchmarks
instead of only documented.

Determinism contract: the injector consumes its RNG exactly once per
fault axis per dispatch ordinal, under a lock, in dispatch order — the
same seed and the same submission sequence replay the same fault
schedule regardless of worker-thread timing. The hooks live behind a
single ``if faults is not None`` check in the scheduler, so production
pays zero cost when disabled.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.analytics import tracing


class InjectedServiceFault(RuntimeError):
    """Raised by ServiceFaultInjector hooks (build fail / wait poison)."""


class ServiceFaultInjector:
    """Seeded, schedule- or rate-driven faults for the serving tier.

    Schedules are DISPATCH ORDINALS: the scheduler ticks one ordinal per
    ``build_task`` call (retries re-tick — a dispatch that fails at
    ordinal k retries as ordinal k+1, so a transient fault is
    ``build_fail_at={k}`` and a persistent one covers every attempt).

      build_fail_at    ordinals whose build raises InjectedServiceFault
      poison_wait_at   ordinals whose task's wait() raises (the first
                       morsel of that dispatch raises inside the worker)
      kill_pool_at     (ordinal, pool_id): kill that worker pool right
                       after the ordinal's task is enqueued — mid-round
      straggle_pool    (pool_id, seconds): delay every morsel that pool
                       executes (the Fig 3 slow-socket analog)
      build_fail_rate / poison_rate
                       seeded Bernoulli per ordinal (chaos storms)
    """

    def __init__(self, seed: int = 0,
                 build_fail_at: Sequence[int] = (),
                 poison_wait_at: Sequence[int] = (),
                 kill_pool_at: Optional[Tuple[int, int]] = None,
                 straggle_pool: Optional[Tuple[int, float]] = None,
                 build_fail_rate: float = 0.0,
                 poison_rate: float = 0.0):
        self.seed = seed
        self.build_fail_at = frozenset(build_fail_at)
        self.poison_wait_at = frozenset(poison_wait_at)
        self.kill_pool_at = kill_pool_at
        self.straggle_pool = straggle_pool
        self.build_fail_rate = build_fail_rate
        self.poison_rate = poison_rate
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._ordinal = 0
        self._poison_pending: set = set()
        self._kill_fired = False
        # observability: what actually fired (asserted by the chaos grid)
        self.builds_failed = 0
        self.waits_poisoned = 0
        self.pools_killed = 0

    def begin_dispatch(self) -> int:
        """Tick one dispatch ordinal; raise to fail this dispatch's build.

        Both rate draws happen unconditionally so the RNG stream depends
        only on the ordinal sequence, never on which faults fired."""
        with self._lock:
            o = self._ordinal
            self._ordinal += 1
            draw_build, draw_poison = self._rng.random(2)
            fail_build = (o in self.build_fail_at
                          or draw_build < self.build_fail_rate)
            if (o in self.poison_wait_at
                    or draw_poison < self.poison_rate):
                self._poison_pending.add(o)
            if fail_build:
                self.builds_failed += 1
                if tracing.tracing_enabled():
                    # flight recorder: every injected fault must leave a
                    # postmortem artifact (the chaos grid asserts it)
                    tracing.tracer().flight_dump(
                        "fault.build_fail", ordinal=o)
                raise InjectedServiceFault(
                    f"injected build failure at dispatch {o}")
            return o

    def on_submit(self, ordinal: int, task, scheduler) -> None:
        """Called by the scheduler after the ordinal's task is enqueued."""
        with self._lock:
            poison = ordinal in self._poison_pending
            self._poison_pending.discard(ordinal)
            kill = (self.kill_pool_at is not None and not self._kill_fired
                    and ordinal >= self.kill_pool_at[0])
            if kill:
                self._kill_fired = True
            if poison:
                self.waits_poisoned += 1
        if poison:
            if tracing.tracing_enabled():
                tracing.tracer().flight_dump(
                    "fault.wait_poison", ordinal=ordinal,
                    trace_id=task.trace_id)
            task.poison(InjectedServiceFault(
                f"injected wait poison at dispatch {ordinal}"))
        if kill:
            with self._lock:
                self.pools_killed += 1
            if tracing.tracing_enabled():
                tracing.tracer().flight_dump(
                    "fault.pool_kill", ordinal=ordinal,
                    pool=self.kill_pool_at[1])
            scheduler.kill_pool(self.kill_pool_at[1])

    def morsel_delay(self, pool_id: int) -> float:
        """Seconds a worker in ``pool_id`` is delayed before each morsel
        (the scheduler sleeps them on the host, or spends them as device
        work on the pool's stream; see ``MorselScheduler``)."""
        if self.straggle_pool is not None and pool_id == self.straggle_pool[0]:
            return self.straggle_pool[1]
        return 0.0
