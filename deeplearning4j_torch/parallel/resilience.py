"""Serving-side admission control and deadlines (port of the parts of
``deeplearning4j_tpu/parallel/resilience.py`` the GenerationServer core
uses): ``ServerOverloaded``, ``AdmissionController``, ``DeadlineExceeded``
and ``Deadline``. Retries, the circuit breaker and chaos injection are not
ported yet (ROADMAP A3b)."""

from __future__ import annotations

import threading
import time
from typing import Callable


class ResilienceError(RuntimeError):
    """Base of the typed serving-failure taxonomy."""


class DeadlineExceeded(ResilienceError):
    """The request's time budget ran out before a result was produced.
    HTTP mapping: 504."""


class ServerOverloaded(ResilienceError):
    """The request was shed: the pending count was at the high-watermark,
    or the request can never fit the server's page budget. HTTP mapping:
    429."""


class AdmissionController:
    """High-watermark load shedding: beyond ``max_pending`` in-flight
    requests, ``acquire()`` raises ``ServerOverloaded`` immediately instead
    of blocking the caller. Release exactly once per acquire (the server
    does it from a future done-callback)."""

    def __init__(self, max_pending: int = 256):
        self.max_pending = max(1, int(max_pending))
        self._lock = threading.Lock()
        self.pending = 0
        self.accepted = 0
        self.rejected = 0

    def acquire(self) -> None:
        with self._lock:
            if self.pending >= self.max_pending:
                self.rejected += 1
                raise ServerOverloaded(
                    f"{self.pending} requests pending, at the "
                    f"max_pending={self.max_pending} high-watermark")
            self.pending += 1
            self.accepted += 1

    def release(self) -> None:
        with self._lock:
            self.pending -= 1


class Deadline:
    """Per-request time budget with remaining-time propagation.

    Created once at admission; every later stage asks ``remaining()``
    instead of re-deriving its own budget, so the request's clock never
    resets as it moves through the server and an expired request is
    failed before a device dispatch is spent on it."""

    __slots__ = ("expires_at", "_clock")

    def __init__(self, budget_s: float, *,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.expires_at = clock() + float(budget_s)

    def remaining(self) -> float:
        """Seconds left in the budget (<= 0 once expired)."""
        return self.expires_at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0
