"""Resilience primitives: circuit breaker + bounded jittered backoff.

Shared by the store client (engine side) and the control plane (proxy
side). Kept dependency-free — core/ must import nothing above it.

Reference: ``agentainer_tpu/core/resilience.py``, copied.
"""

from __future__ import annotations

import random
import threading
import time


class CircuitBreaker:
    """Failure-counting breaker for a dependency that can hang or flap.

    Closed → every call allowed. ``failure_threshold`` consecutive
    failures open it: calls are refused instantly (the caller answers
    503 + Retry-After instead of stacking timeouts on a dead store).
    After ``cooldown_s`` ONE probe call is allowed through (half-open);
    its outcome closes the breaker or re-opens it for another cooldown.

    Thread-safe; success/failure recording is the caller's job because
    only the caller knows which exceptions are the dependency's fault.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 2.0):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        # lifetime counters for the metrics plane
        self.opens_total = 0
        self.refused_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        """May a call proceed right now? In half-open state exactly one
        caller wins the probe; the rest stay refused until it settles."""
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at < self.cooldown_s:
                self.refused_total += 1
                return False
            if self._probing:
                self.refused_total += 1
                return False
            self._probing = True
            return True

    def ok(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def fail(self) -> None:
        with self._lock:
            self._probing = False
            self._failures += 1
            if self._opened_at is not None:
                # failed probe: full cooldown again
                self._opened_at = time.monotonic()
            elif self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()
                self.opens_total += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": (
                    "closed"
                    if self._opened_at is None
                    else (
                        "half-open"
                        if time.monotonic() - self._opened_at >= self.cooldown_s
                        else "open"
                    )
                ),
                "consecutive_failures": self._failures,
                "opens_total": self.opens_total,
                "refused_total": self.refused_total,
            }


class KeyedBreakers:
    """A family of independent CircuitBreakers keyed by string (one per
    engine replica): a replica that keeps failing opens ITS breaker only,
    so the agent's other replicas keep serving — the whole point of the
    per-replica split versus one breaker per agent."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 2.0):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(
                    failure_threshold=self.failure_threshold,
                    cooldown_s=self.cooldown_s,
                )
            return br

    def drop(self, key: str) -> None:
        """Forget a replaced/removed replica's breaker (a respawned engine
        gets a fresh id, so stale entries would only leak)."""
        with self._lock:
            self._breakers.pop(key, None)

    def stats(self) -> dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {key: br.stats() for key, br in items}


def retry_after_jitter(
    base_s: float, rng: random.Random | None = None, spread: float = 0.5
) -> int:
    """Retry-After seconds with multiplicative jitter in [1-spread/2,
    1+spread/2): a fleet of clients shed in the same instant must NOT come
    back in the same instant — synchronized retries re-stampede exactly
    the replica that was recovering. Pass a seeded ``rng`` for a
    deterministic sequence (tests, chaos). Result is a whole second >= 1
    (the HTTP header is integer seconds)."""
    r = rng or random
    return max(1, int(round(base_s * (1.0 - spread / 2 + spread * r.random()))))


def backoff_delays(
    retries: int,
    base_s: float = 0.05,
    max_s: float = 2.0,
    jitter: float = 0.5,
    rng: random.Random | None = None,
) -> list[float]:
    """Exponential backoff schedule with multiplicative jitter: attempt n
    sleeps ``base * 2**n`` (capped) scaled by ``1 ± jitter/2``. Pass a
    seeded ``rng`` for a deterministic schedule (chaos soak)."""
    r = rng or random
    out = []
    for n in range(max(0, int(retries))):
        d = min(max_s, base_s * (2**n))
        out.append(d * (1.0 - jitter / 2 + jitter * r.random()))
    return out
