"""Serving-side admission control (port of the parts of
``deeplearning4j_tpu/parallel/resilience.py`` the GenerationServer core
uses): ``ServerOverloaded`` and ``AdmissionController``. Deadlines, retries,
the circuit breaker and chaos injection are not ported yet."""

from __future__ import annotations

import threading


class ResilienceError(RuntimeError):
    """Base of the typed serving-failure taxonomy."""


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
