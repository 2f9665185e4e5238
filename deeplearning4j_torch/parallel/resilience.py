"""Serving-side resilience primitives: deadlines, admission control,
retries, a circuit breaker, and a deterministic chaos injector (the port's
own copy of ``deeplearning4j_tpu/parallel/resilience.py``).

The contract every component here enforces is the SRE one: a submitted
request either resolves, or fails promptly with an error from the taxonomy
below; it is never left pending forever, and an overloaded server sheds
load instead of queueing it unboundedly. The designs are the standard
model-server guardrails: decorrelated-jitter backoff, a closed -> open ->
half-open breaker over a sliding outcome window, and high-watermark
admission control.

Everything in this module is host-side stdlib (no torch, no device
state). ``ChaosPolicy`` draws from Python's ``random`` exactly as the JAX
package's does, so a policy with a given seed injects the same fault
sequence in both packages.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Optional, Tuple


class ResilienceError(RuntimeError):
    """Base of the typed serving-failure taxonomy. Every admitted request
    either resolves or fails with one of these subclasses (or with the
    original dispatch error once the retry budget is spent) — never
    silently dropped, never left pending."""


class DeadlineExceeded(ResilienceError):
    """The request's time budget ran out before a result was produced.
    HTTP mapping: 504."""


class ServerOverloaded(ResilienceError):
    """Admission control shed the request: the pending count was at the
    high-watermark. Raised immediately at submit — the caller is told to
    back off rather than being blocked behind an unbounded queue.
    HTTP mapping: 429."""


class CircuitOpen(ResilienceError):
    """The circuit breaker is open: recent dispatches failed above the
    threshold rate, so new work is fast-failed until a half-open probe
    succeeds. HTTP mapping: 503."""


class TransientDispatchError(ResilienceError):
    """A dispatch failure worth retrying (device hiccup, transient
    transport error). ``RetryPolicy`` retries exactly these; anything
    else propagates on the first attempt. HTTP mapping: 503 (when the
    retry budget is exhausted)."""


class ReplicaKilled(ResilienceError):
    """A model replica died mid-request (process crash, device loss, or an
    injected chaos kill). Non-retryable at the replica level — the replica
    is gone — but the fleet router re-dispatches the victim requests to a
    surviving replica, so callers behind a ``ReplicaFleet`` normally never
    see this. HTTP mapping: 503 (when it does escape)."""


class ReplicaUnavailable(ResilienceError):
    """No replica can take the request right now: every fleet member is
    dead, restarting, draining, or breaker-open. Raised at submit so the
    caller sheds load instead of queueing behind a fleet that cannot make
    progress. HTTP mapping: 503."""


class Deadline:
    """Per-request time budget with remaining-time propagation.

    Created once at admission; every later stage (queue pickup, batch
    assembly, padding, each retry attempt) asks ``remaining()`` instead of
    re-deriving its own budget, so the request's clock never resets as it
    moves through the pipeline and an expired request is failed *before*
    a device program is wasted on it."""

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


class RetryPolicy:
    """Capped exponential backoff with decorrelated jitter, retrying ONLY
    transient errors.

    ``sleep_{i+1} ~ U[base_s, 3 * sleep_i]`` capped at ``cap_s`` — the
    decorrelated variant spreads concurrent retriers apart instead of
    synchronizing them into retry storms. Deterministic under ``seed``;
    ``sleep`` is injectable so tests run at full speed."""

    def __init__(self, max_attempts: int = 3, base_s: float = 0.005,
                 cap_s: float = 0.25,
                 retry_on: Tuple[type, ...] = (TransientDispatchError,),
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.retry_on = tuple(retry_on)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()

    def backoff_s(self, previous: float) -> float:
        with self._lock:  # one rng shared by concurrent dispatch threads
            return min(self.cap_s,
                       self._rng.uniform(self.base_s,
                                         max(self.base_s, 3.0 * previous)))

    def call(self, fn: Callable, *args,
             deadline: Optional[Deadline] = None,
             on_retry: Optional[Callable[[int, Exception], None]] = None):
        """Run ``fn(*args)`` retrying transient failures until the attempt
        budget — or the request's deadline — runs out. A backoff that the
        deadline cannot cover gives up immediately (re-raising the
        transient error) instead of sleeping past the budget."""
        delay = self.base_s
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args)
            except self.retry_on:
                if attempt >= self.max_attempts:
                    raise
                delay = self.backoff_s(delay)
                if deadline is not None and deadline.remaining() <= delay:
                    raise
                if on_retry is not None:
                    on_retry(attempt, None)
                self._sleep(delay)


class CircuitBreaker:
    """closed -> open (failure rate over a sliding window crosses the
    threshold) -> half-open probe after ``reset_timeout_s`` -> closed on
    probe success, reopened on probe failure.

    ``allow()`` is the admission-side gate (an open breaker fast-fails new
    submits); ``record_success``/``record_failure`` are fed per dispatch
    attempt. The clock is injectable so state transitions are testable
    without real waiting."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: float = 0.5, window: int = 16,
                 min_calls: int = 8, reset_timeout_s: float = 5.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = float(failure_threshold)
        self.min_calls = max(1, int(min_calls))
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._outcomes: deque = deque(maxlen=max(1, int(window)))
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probes = 0
        self._half_open_at = 0.0
        #: times the breaker tripped open (monotone counter, for stats())
        self.open_count = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._current_state()

    def _current_state(self) -> str:
        # lock held; OPEN decays to HALF_OPEN once the reset timeout passes
        now = self._clock()
        if (self._state == self.OPEN
                and now - self._opened_at >= self.reset_timeout_s):
            self._state = self.HALF_OPEN
            self._probes = 0
            self._half_open_at = now
        elif (self._state == self.HALF_OPEN
                and now - self._half_open_at >= self.reset_timeout_s):
            # probes that never reported an outcome (e.g. the probe request
            # expired before dispatch) must not wedge the breaker in a
            # probe-exhausted half-open state: replenish periodically
            self._probes = 0
            self._half_open_at = now
        return self._state

    def allow(self) -> bool:
        """May new work enter? CLOSED: yes. OPEN: no (fast-fail).
        HALF_OPEN: up to ``half_open_probes`` probes, then no."""
        with self._lock:
            st = self._current_state()
            if st == self.CLOSED:
                return True
            if st == self.OPEN:
                return False
            if self._probes < self.half_open_probes:
                self._probes += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._current_state() == self.HALF_OPEN:
                # the probe came back healthy: close and start fresh
                self._state = self.CLOSED
                self._outcomes.clear()
            else:
                self._outcomes.append(True)

    def record_failure(self) -> None:
        with self._lock:
            if self._current_state() == self.HALF_OPEN:
                self._trip()  # the probe failed: straight back to open
                return
            self._outcomes.append(False)
            n = len(self._outcomes)
            failures = n - sum(self._outcomes)
            if n >= self.min_calls and failures / n >= self.failure_threshold:
                self._trip()

    def _trip(self) -> None:
        # lock held
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._outcomes.clear()
        self.open_count += 1


class AdmissionController:
    """High-watermark load shedding: beyond ``max_pending`` in-flight
    requests, ``acquire()`` raises ``ServerOverloaded`` immediately
    instead of blocking the caller. Also the server's accepted/rejected/
    pending bookkeeping — release exactly once per acquire (the serving
    layers do it from a future done-callback, which covers every
    resolution path)."""

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


class ChaosPolicy:
    """Deterministic, seedable fault injector for tests and the chaos
    bench — wraps a dispatch callable to inject latency, transient errors
    (retryable), and hard errors, at independent per-call rates drawn from
    one seeded rng. All rates default to 0 and nothing in the production
    path constructs one: chaos only exists where a test or bench passes it
    in explicitly.

    Replica-targeted fault modes (for ``ReplicaFleet`` drills; give each
    replica its own policy with a distinct seed to target them
    independently):

    - ``kill_rate``: raise ``ReplicaKilled`` — a hard, non-retryable
      replica death. Inside a ``GenerationServer`` dispatch this takes the
      hard-fault path (every in-flight request on the replica fails typed),
      which is exactly the signal the fleet treats as replica death.
    - ``stall_rate``/``stall_s``: the dispatch freezes for ``stall_s``
      before running — a straggler replica, the hedging target.
    - ``slow_rate``/``slow_factor``: the dispatch runs, then the wrapper
      sleeps ``(slow_factor - 1) x`` the measured run time — slow-decode,
      degrading throughput without ever failing.

    The replica-mode randoms are drawn only when one of the replica rates
    is non-zero, so pre-existing seeds reproduce the same latency/error
    sequences as before.

    Handoff fault modes (for the KV-snapshot migration drills in
    ``parallel/handoff.py``; injected via ``handoff_fault()`` from the
    snapshot path, never from ``wrap()``):

    - ``snapshot_corrupt_rate``: the snapshot about to ship gets one
      payload bit flipped after its checksum was computed, so the
      adopter's ``verify()`` fails and the fleet falls back to token-0
      regeneration.
    - ``handoff_stall_rate``/``handoff_stall_s``: the snapshot path
      freezes for ``handoff_stall_s`` — a slow migration wire.
    - ``handoff_drop_rate``: the transfer vanishes in flight — the
      snapshot is never published/shipped, so the consumer sees a typed
      ``SnapshotUnavailable`` failure and re-runs the work elsewhere.
    - ``handoff_truncate_rate``: the transfer is cut short — the wire
      tail reads back as zeros, so the adopter's checksum ``verify()``
      fails and it falls back to token-0 regeneration.

    ``handoff_fault()``/``handoff_fault_mode()`` draw from the shared
    rng only when one of the handoff rates is non-zero, so legacy
    wrap() sequences are reproduced bit-for-bit even on servers that
    call it every loop; the new drop/truncate rates gate the draw the
    same way, so pre-existing handoff fault sequences (corrupt/stall
    only) also stay pinned.

    Shutdown-phase fault modes (for the ``ServingLoop`` lifecycle
    drills in ``parallel/runtime.py``; injected via ``drain_fault()``
    from a DRAINING loop's tick path and ``sentinel_fault()`` from its
    clean-exit path, never from ``wrap()``):

    - ``kill_during_drain_rate``: raise ``LoopKilled`` (a
      ``BaseException``, so server loop bodies that catch ``Exception``
      to keep serving cannot swallow it) — the loop thread dies
      mid-drain and the supervisor must recover every in-flight future.
    - ``stall_sentinel_rate``/``stall_sentinel_s``: the loop thread
      freezes for ``stall_sentinel_s`` as it exits cleanly —
      ``close(timeout)`` must give up on the join and return without
      stranding a future.

    Both draws are gated on their own non-zero rates, so every legacy
    seeded sequence (wrap, replica, handoff) stays pinned.

    Network fault modes (for the cross-host federation drills of the JAX
    package's ``parallel/federation.py``; injected from the framed-RPC
    link path via ``net_connect_fault()`` per outbound connect and
    ``net_fault_mode()`` per frame sent, never from ``wrap()``):

    - ``conn_refused_rate``: the outbound connect attempt raises
      ``ConnectionRefusedError`` — the host's listener is gone (or a
      firewall ate the SYN); the router's per-host RetryPolicy and
      breaker absorb it.
    - ``partition_rate``/``partition_s``: the link becomes unreachable
      for a ``partition_s``-second window (monotonic clock) — every
      send inside the window fails ``TransientDispatchError`` without
      touching the socket, the CI stand-in for a network partition
      that heals. ``net_partitioned()`` reports the window state.
    - ``slow_link_factor``: every frame pays a deterministic
      serialization delay of ``(factor - 1) x nbytes / 100 MB/s`` — a
      degraded NIC. No rng draw at all (factor 1.0 = off), so it can
      never perturb a seeded sequence.
    - ``frame_corrupt_rate``: one bit of the frame body is flipped
      after the length prefix is written, so the receiver's framed
      reader rejects it typed (``FederationProtocolError`` /
      checksum failure) instead of trusting damaged bytes.

    ``net_connect_fault()`` and ``net_fault_mode()`` each draw from
    the shared rng only when their own rates are non-zero (the
    partition/corrupt pair shares one stacked-threshold draw, mutually
    exclusive per frame like the replica modes), so all legacy fault
    sequences — wrap, replica, handoff, shutdown — replay pinned."""

    #: nominal healthy link bandwidth the ``slow_link_factor`` delay is
    #: computed against (bytes/second)
    LINK_BYTES_PER_S = 100e6

    def __init__(self, seed: int = 0, transient_rate: float = 0.0,
                 hard_rate: float = 0.0, latency_s: float = 0.0,
                 latency_rate: float = 0.0,
                 kill_rate: float = 0.0,
                 stall_rate: float = 0.0, stall_s: float = 0.0,
                 slow_rate: float = 0.0, slow_factor: float = 1.0,
                 snapshot_corrupt_rate: float = 0.0,
                 handoff_stall_rate: float = 0.0,
                 handoff_stall_s: float = 0.0,
                 handoff_drop_rate: float = 0.0,
                 handoff_truncate_rate: float = 0.0,
                 kill_during_drain_rate: float = 0.0,
                 stall_sentinel_rate: float = 0.0,
                 stall_sentinel_s: float = 0.0,
                 conn_refused_rate: float = 0.0,
                 partition_rate: float = 0.0,
                 partition_s: float = 0.0,
                 slow_link_factor: float = 1.0,
                 frame_corrupt_rate: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.transient_rate = float(transient_rate)
        self.hard_rate = float(hard_rate)
        self.latency_s = float(latency_s)
        self.latency_rate = float(latency_rate)
        self.kill_rate = float(kill_rate)
        self.stall_rate = float(stall_rate)
        self.stall_s = float(stall_s)
        self.slow_rate = float(slow_rate)
        self.slow_factor = float(slow_factor)
        self.snapshot_corrupt_rate = float(snapshot_corrupt_rate)
        self.handoff_stall_rate = float(handoff_stall_rate)
        self.handoff_stall_s = float(handoff_stall_s)
        self.handoff_drop_rate = float(handoff_drop_rate)
        self.handoff_truncate_rate = float(handoff_truncate_rate)
        self.kill_during_drain_rate = float(kill_during_drain_rate)
        self.stall_sentinel_rate = float(stall_sentinel_rate)
        self.stall_sentinel_s = float(stall_sentinel_s)
        self.conn_refused_rate = float(conn_refused_rate)
        self.partition_rate = float(partition_rate)
        self.partition_s = float(partition_s)
        self.slow_link_factor = float(slow_link_factor)
        self.frame_corrupt_rate = float(frame_corrupt_rate)
        self._partition_until = 0.0
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected_transient = 0
        self.injected_hard = 0
        self.injected_latency = 0
        self.injected_kill = 0
        self.injected_stall = 0
        self.injected_slow = 0
        self.injected_snapshot_corrupt = 0
        self.injected_handoff_stall = 0
        self.injected_handoff_drop = 0
        self.injected_handoff_truncate = 0
        self.injected_drain_kill = 0
        self.injected_sentinel_stall = 0
        self.injected_conn_refused = 0
        self.injected_partition = 0
        self.injected_slow_link = 0
        self.injected_frame_corrupt = 0

    def net_connect_fault(self) -> None:
        """One seeded draw per outbound connect attempt on a federation
        link (and only when ``conn_refused_rate`` is non-zero, so every
        legacy seeded sequence stays pinned). On a hit, raises
        ``ConnectionRefusedError`` before the socket is touched — the
        same error a dead listener produces, so the router's retry /
        breaker / reconnect machinery cannot tell injection from the
        real thing."""
        if not self.conn_refused_rate:
            return
        with self._lock:
            hit = self._rng.random() < self.conn_refused_rate
            if hit:
                self.injected_conn_refused += 1
        if hit:
            raise ConnectionRefusedError(
                "chaos: connection refused by injected fault")

    def net_partitioned(self) -> bool:
        """True while the link is inside an injected partition window
        (armed by a ``net_fault_mode()`` partition hit)."""
        with self._lock:
            until = self._partition_until
        return time.monotonic() < until

    def net_fault_mode(self, nbytes: int = 0) -> Optional[str]:
        """One seeded draw per frame sent on a federation link, gated
        on the partition/corrupt rates being non-zero so all legacy
        sequences replay pinned. The ``slow_link_factor`` delay is
        deterministic (no draw): ``(factor - 1) x nbytes`` over a
        nominal 100 MB/s link, applied before the draw. Returns the
        injected mode — ``"partition"`` (window armed; the caller must
        fail the send without touching the socket) or ``"corrupt"``
        (the caller flips one bit of the frame body) — or None. The
        modes share one stacked-threshold draw, mutually exclusive per
        frame like the replica modes."""
        if self.slow_link_factor > 1.0 and nbytes > 0:
            with self._lock:
                self.injected_slow_link += 1
            self._sleep((self.slow_link_factor - 1.0)
                        * nbytes / self.LINK_BYTES_PER_S)
        if not (self.partition_rate or self.frame_corrupt_rate):
            return None
        with self._lock:
            r = self._rng.random()
            t = self.partition_rate
            part = r < t
            t += self.frame_corrupt_rate
            corrupt = not part and r < t
            if part:
                self.injected_partition += 1
                self._partition_until = time.monotonic() + self.partition_s
            if corrupt:
                self.injected_frame_corrupt += 1
        if part:
            return "partition"
        if corrupt:
            return "corrupt"
        return None

    def drain_fault(self) -> None:
        """One seeded draw per tick run while the hosting
        ``ServingLoop`` is DRAINING (and only when the rate is non-zero,
        so every legacy seeded sequence stays pinned). On a hit, raises
        ``LoopKilled`` — a ``BaseException`` that escapes the server
        loop bodies' ``except Exception`` recovery and takes the loop
        thread down mid-drain, which is exactly the failure the
        supervisor contract must absorb."""
        if not self.kill_during_drain_rate:
            return
        with self._lock:
            hit = self._rng.random() < self.kill_during_drain_rate
            if hit:
                self.injected_drain_kill += 1
        if hit:
            from deeplearning4j_torch.parallel.runtime import LoopKilled
            raise LoopKilled("chaos: loop thread killed mid-drain")

    def sentinel_fault(self) -> None:
        """One seeded draw per tick loop exiting cleanly; gated on its
        own non-zero rate so legacy sequences stay pinned. On a hit, the
        exiting thread stalls for ``stall_sentinel_s`` —
        ``close(timeout)`` must not hang on the join."""
        if not self.stall_sentinel_rate:
            return
        with self._lock:
            hit = self._rng.random() < self.stall_sentinel_rate
            if hit:
                self.injected_sentinel_stall += 1
        if hit:
            self._sleep(self.stall_sentinel_s)

    def handoff_fault(self) -> bool:
        """Legacy boolean form of ``handoff_fault_mode()``: returns True
        iff the snapshot should be corrupted (the only mode its first
        consumers knew). Same single draw, same counters."""
        return self.handoff_fault_mode() == "corrupt"

    def handoff_fault_mode(self) -> Optional[str]:
        """One seeded draw per snapshot shipped (and only when a handoff
        rate is non-zero, so wrap() sequences stay pinned — and legacy
        corrupt/stall thresholds stay pinned when the new rates are 0).
        Performs the ``handoff_stall`` sleep itself, outside the rng
        lock. Returns the injected fault mode — ``"corrupt"``,
        ``"drop"``, or ``"truncate"`` — or None (a stall delays the
        transfer but does not damage it). The modes are mutually
        exclusive per draw, stacked corrupt-then-stall-then-drop-then-
        truncate like the replica modes."""
        if not (self.snapshot_corrupt_rate or self.handoff_stall_rate
                or self.handoff_drop_rate or self.handoff_truncate_rate):
            return None
        with self._lock:
            r = self._rng.random()
            t = self.snapshot_corrupt_rate
            corrupt = r < t
            t += self.handoff_stall_rate
            stall = not corrupt and r < t
            t += self.handoff_drop_rate
            drop = not (corrupt or stall) and r < t
            t += self.handoff_truncate_rate
            truncate = not (corrupt or stall or drop) and r < t
            if corrupt:
                self.injected_snapshot_corrupt += 1
            if stall:
                self.injected_handoff_stall += 1
            if drop:
                self.injected_handoff_drop += 1
            if truncate:
                self.injected_handoff_truncate += 1
        if stall:
            self._sleep(self.handoff_stall_s)
        if corrupt:
            return "corrupt"
        if drop:
            return "drop"
        if truncate:
            return "truncate"
        return None

    def wrap(self, fn: Callable) -> Callable:
        """The chaotic twin of ``fn``: same signature, same result, but
        each call may first sleep and/or raise per the configured rates."""

        def chaotic(*args, **kwargs):
            with self._lock:  # one rng, many dispatch threads
                r_latency = self._rng.random()
                r_error = self._rng.random()
                inject_latency = (self.latency_rate
                                  and r_latency < self.latency_rate)
                inject_hard = self.hard_rate and r_error < self.hard_rate
                inject_transient = (self.transient_rate and not inject_hard
                                    and r_error < (self.hard_rate
                                                   + self.transient_rate))
                inject_kill = inject_stall = inject_slow = False
                if self.kill_rate or self.stall_rate or self.slow_rate:
                    # stacked thresholds on one extra draw: at most one
                    # replica-targeted fault per call, mutually exclusive
                    r_rep = self._rng.random()
                    inject_kill = r_rep < self.kill_rate
                    inject_stall = (not inject_kill
                                    and r_rep < (self.kill_rate
                                                 + self.stall_rate))
                    inject_slow = (not (inject_kill or inject_stall)
                                   and r_rep < (self.kill_rate
                                                + self.stall_rate
                                                + self.slow_rate))
                if inject_latency:
                    self.injected_latency += 1
                if inject_hard:
                    self.injected_hard += 1
                if inject_transient:
                    self.injected_transient += 1
                if inject_kill:
                    self.injected_kill += 1
                if inject_stall:
                    self.injected_stall += 1
                if inject_slow:
                    self.injected_slow += 1
            if inject_latency:
                self._sleep(self.latency_s)
            if inject_stall:
                self._sleep(self.stall_s)
            if inject_kill:
                raise ReplicaKilled("chaos: replica killed")
            if inject_hard:
                raise RuntimeError("chaos: injected hard fault")
            if inject_transient:
                raise TransientDispatchError("chaos: injected transient "
                                             "fault")
            if inject_slow:
                t0 = time.monotonic()
                out = fn(*args, **kwargs)
                if self.slow_factor > 1.0:
                    self._sleep((self.slow_factor - 1.0)
                                * (time.monotonic() - t0))
                return out
            return fn(*args, **kwargs)

        return chaotic
