"""Retry policy: bounded attempts, exponential backoff, deterministic jitter
(the port of ``repro.analytics.service.retry``: the same floats).

A failed dispatch (build raised, wait() poisoned, hang-budget timeout) is
retried up to ``max_attempts`` total attempts with exponentially growing
backoff. Jitter is DETERMINISTIC — a hash of (request key, attempt) — so
a replayed fault schedule produces a replayed retry schedule; real
deployments get the thundering-herd spread, tests get reproducibility.

The per-request deadline is respected ACROSS attempts: ``give_up_at``
caps the next backoff against the deadline, so a request never sleeps
through its own budget — it is reported expired/exhausted instead of
retried past the point a client stopped listening.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _hash_frac(key: int, attempt: int) -> float:
    """Deterministic uniform-ish fraction in [0, 1) from (key, attempt)."""
    h = (key * 2654435761 + attempt * 40503 + 0x9E3779B9) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x45D9F3B) & 0xFFFFFFFF
    h ^= h >> 16
    return h / 2.0 ** 32


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` counts the first try: 3 = one try + two retries."""

    max_attempts: int = 3
    base_backoff_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.5            # fraction of the backoff randomized away

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def backoff_s(self, attempt: int, key: int = 0) -> float:
        """Sleep before attempt ``attempt+1`` (attempt is 1-based tries
        already made). Jitter subtracts up to ``jitter`` of the backoff —
        deterministic in (key, attempt)."""
        raw = min(self.max_backoff_s,
                  self.base_backoff_s * self.multiplier ** (attempt - 1))
        return raw * (1.0 - self.jitter * _hash_frac(key, attempt))

    def should_retry(self, attempt: int, now: float,
                     deadline_s: Optional[float], key: int = 0) -> bool:
        """True when another attempt is allowed AND its backoff fits the
        request's remaining deadline budget."""
        if attempt >= self.max_attempts:
            return False
        if deadline_s is None:
            return True
        return now + self.backoff_s(attempt, key) < deadline_s
