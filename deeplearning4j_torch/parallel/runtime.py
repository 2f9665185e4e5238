"""Supervised serving runtime: the lifecycle of a serving loop thread
(the port's own copy of ``deeplearning4j_tpu/parallel/runtime.py``, tick
mode only).

``ServingLoop`` defines the drain/close choreography and crash recovery
of a serving loop thread exactly once:

    NEW --start()--> RUNNING --begin_drain()--> DRAINING --close()--> CLOSED
                        |                           |
                        +----------- close() -------+--------------> CLOSED

* ``start()`` is legal only from NEW (``IllegalLoopTransition`` otherwise).
* ``begin_drain()`` is idempotent: a no-op from DRAINING or CLOSED.
* ``close()`` is idempotent and re-entrant from any thread: the first
  caller performs the shutdown, concurrent callers block on the same
  completion event.
* ``restart()`` is legal only from CLOSED and is how the supervisor
  implements supervised restart.

The loop owns one thread repeatedly calling ``tick()`` until it returns
False or the loop leaves RUNNING / DRAINING. ``wake`` is called (outside
any runtime lock) whenever the state machine advances, so a tick body
blocked on its own condition variable can re-check state promptly. The
JAX package's second hosting mode (an inbox consumed by a worker pool)
has no consumer in the port yet and is not copied.

``LoopSupervisor`` watches registered loops, detects loop-thread death
(a crash recorded by the loop, or the liveness backstop: a RUNNING loop
whose thread is gone without a clean exit), and runs the uniform
recovery contract: finish the crash (release waiters), call the owner's
``on_death`` hook (where servers fail their in-flight futures with the
typed ``LoopCrashed``), and optionally restart the loop with exponential
backoff.

Lock order: ``ServingLoop._cond`` before ``LoopSupervisor._lock``, never
the other way round. The runtime NEVER invokes user callbacks (``tick``,
``wake``, ``on_death``) while holding ``_cond``, and the supervisor never
calls loop methods while holding ``_lock``.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Any, Callable, List, Optional


class LoopError(RuntimeError):
    """Base class for serving-runtime lifecycle errors."""


class IllegalLoopTransition(LoopError):
    """A lifecycle method was called from a state that forbids it."""


class LoopCrashed(LoopError):
    """The owning loop thread died; in-flight work was failed with this."""


class LoopKilled(BaseException):
    """Chaos-injected loop-thread death.

    Deliberately NOT an ``Exception``: server loop bodies catch
    ``Exception`` to fail in-flight work and keep serving, and the whole
    point of ``kill_during_drain`` chaos is to escape those handlers and
    take the thread down, exactly like an untrappable runtime failure.
    Futures are never failed with this directly — the recovery path
    wraps it in ``LoopCrashed`` (a plain ``Exception``).
    """


class LoopState(enum.Enum):
    NEW = "new"
    RUNNING = "running"
    DRAINING = "draining"
    CLOSED = "closed"


NEW = LoopState.NEW
RUNNING = LoopState.RUNNING
DRAINING = LoopState.DRAINING
CLOSED = LoopState.CLOSED


class ServingLoop:
    """One supervised tick loop and the NEW → RUNNING → DRAINING → CLOSED
    state machine. ``tick()`` returns True to keep running, False to stop
    cleanly; ``wake()`` is invoked when the state machine advances."""

    def __init__(self, name: str, *,
                 tick: Callable[[], bool],
                 wake: Optional[Callable[[], None]] = None,
                 chaos: Any = None,
                 daemon: bool = True):
        self.name = name
        self._tick = tick
        self._wake = wake
        self._daemon = daemon
        self._cond = threading.Condition()
        self._state = LoopState.NEW
        self._chaos = chaos
        self._threads: List[threading.Thread] = []
        self._clean_exit = False    # tick loop returned False (under _cond)
        self._crash_exc: Optional[BaseException] = None
        self._crash_handled = False
        self._closer: Optional[int] = None   # thread ident of sole closer
        self._retired = False    # deliberate close(): restart() forbidden
        self._closed_evt = threading.Event()
        self._supervisor: Optional["LoopSupervisor"] = None
        self.generation = 0
        self.restarts = 0

    # ------------------------------------------------------------- state
    @property
    def state(self) -> LoopState:
        return self._state

    @property
    def crashed(self) -> Optional[BaseException]:
        """First exception that took the loop thread down, else None."""
        with self._cond:
            return self._crash_exc

    # --------------------------------------------------------- lifecycle
    def start(self) -> "ServingLoop":
        with self._cond:
            if self._state is not LoopState.NEW:
                raise IllegalLoopTransition(
                    f"{self.name}: start() from {self._state.value}")
            self._state = LoopState.RUNNING
            self._spawn_locked()
        return self

    def _spawn_locked(self) -> None:
        """Spawn the tick thread. Caller holds ``_cond``."""
        self._clean_exit = False
        t = threading.Thread(target=self._tick_main, daemon=self._daemon,
                             name=self.name)
        self._threads.append(t)
        t.start()

    def begin_drain(self) -> None:
        """RUNNING → DRAINING. Idempotent: no-op from DRAINING/CLOSED."""
        with self._cond:
            if self._state is not LoopState.RUNNING:
                return
            self._state = LoopState.DRAINING
            self._cond.notify_all()
        if self._wake is not None:
            self._wake()

    def close(self, timeout: float = 30.0) -> None:
        """DRAINING/RUNNING/NEW → CLOSED. Idempotent and re-entrant: the
        first caller shuts the loop down, concurrent callers wait on the
        same completion event."""
        with self._cond:
            # a deliberate close is final even when it loses the race to
            # a crash: a pending supervised restart must not resurrect a
            # loop the owner just closed
            self._retired = True
            if self._state is LoopState.CLOSED or self._closer is not None:
                sole = False
            else:
                sole = True
                self._closer = threading.get_ident()
                self._state = LoopState.CLOSED
                self._cond.notify_all()
                threads = list(self._threads)
        if not sole:
            self._closed_evt.wait(timeout)
            sup = self._supervisor
            if sup is not None:
                sup.unwatch(self)
            return
        if self._wake is not None:
            self._wake()
        deadline = time.monotonic() + max(0.0, timeout)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._closed_evt.set()
        sup = self._supervisor
        if sup is not None:
            sup.unwatch(self)

    def restart(self) -> "ServingLoop":
        """CLOSED → RUNNING with a fresh thread. Supervisor-driven."""
        with self._cond:
            if self._state is not LoopState.CLOSED:
                raise IllegalLoopTransition(
                    f"{self.name}: restart() from {self._state.value}")
            if self._retired:
                raise IllegalLoopTransition(
                    f"{self.name}: restart() after deliberate close()")
            self._crash_exc = None
            self._crash_handled = False
            self._closer = None
            self._closed_evt = threading.Event()
            self._threads = [t for t in self._threads if t.is_alive()]
            self.generation += 1
            self.restarts += 1
            self._state = LoopState.RUNNING
            self._spawn_locked()
        return self

    # ------------------------------------------------------- thread main
    def _tick_main(self) -> None:
        exc: Optional[BaseException] = None
        clean = False
        try:
            while True:
                if self._state is LoopState.CLOSED:
                    clean = True
                    break
                if self._state is LoopState.DRAINING:
                    chaos = self._chaos
                    if chaos is not None:
                        fault = getattr(chaos, "drain_fault", None)
                        if fault is not None:
                            fault()
                if not self._tick():
                    clean = True
                    break
            chaos = self._chaos
            if chaos is not None and clean:
                fault = getattr(chaos, "sentinel_fault", None)
                if fault is not None:
                    fault()
        except BaseException as e:  # noqa: BLE001 - crash recording
            exc = e
        finally:
            self._retire(exc)

    def _retire(self, exc: Optional[BaseException]) -> None:
        """The tick thread's exit path: record a clean exit, or a crash
        for the supervisor. A clean exit keeps the supervisor's liveness
        backstop from mistaking a deliberately stopped loop for a dead
        one."""
        with self._cond:
            if exc is None:
                self._clean_exit = True
            self._cond.notify_all()
        if exc is not None:
            self._note_crash(exc)

    def _note_crash(self, exc: BaseException) -> None:
        with self._cond:
            if self._crash_exc is None:
                self._crash_exc = exc
            sup = self._supervisor
        if sup is not None:
            sup.ping()

    def _finish_crash(self, exc: BaseException) -> bool:
        """Supervisor-driven crash completion: force CLOSED, wake the
        tick body, release close() waiters. Returns False when the crash
        was already handled (idempotent)."""
        with self._cond:
            if self._crash_handled:
                return False
            self._crash_handled = True
            if self._crash_exc is None:
                self._crash_exc = exc
            already_closed = self._state is LoopState.CLOSED
            self._state = LoopState.CLOSED
            self._cond.notify_all()
        if self._wake is not None:
            self._wake()
        self._closed_evt.set()
        return not already_closed

    # ------------------------------------------------------- supervision
    def _attach(self, sup: "LoopSupervisor") -> None:
        with self._cond:
            self._supervisor = sup

    def _detach(self) -> None:
        with self._cond:
            self._supervisor = None


class LoopSupervisor:
    """Watches ``ServingLoop``s for thread death and runs the uniform
    recovery contract:

    1. ``loop._finish_crash(exc)`` — force CLOSED, release waiters.
    2. ``on_death(loop, exc)`` — the owner fails its in-flight futures
       with ``LoopCrashed``. Returning False vetoes the restart (servers
       return False once they are deliberately closing).
    3. optional ``loop.restart()`` after exponential backoff.

    The supervisor thread copies its watch table under ``_lock`` and acts
    entirely outside it, so recovery callbacks may take server locks of
    any rank.
    """

    def __init__(self, poll_s: float = 0.05):
        self._lock = threading.Lock()
        self._watched: dict = {}     # loop -> entry dict
        self._ping = threading.Event()
        self._poll_s = poll_s
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.recoveries = 0

    def watch(self, loop: ServingLoop, *,
              on_death: Optional[
                  Callable[[ServingLoop, BaseException], Any]] = None,
              restart: bool = False, backoff_s: float = 0.05,
              backoff_cap_s: float = 2.0) -> None:
        entry = {"on_death": on_death, "restart": restart,
                 "backoff_s": backoff_s, "backoff_cap_s": backoff_cap_s,
                 "attempts": 0, "handled_gen": -1}
        with self._lock:
            self._watched[loop] = entry
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(
                    target=self._scan_loop, daemon=True,
                    name="loop-supervisor")
                self._thread.start()
        loop._attach(self)

    def unwatch(self, loop: ServingLoop) -> None:
        with self._lock:
            self._watched.pop(loop, None)
        loop._detach()

    def ping(self) -> None:
        self._ping.set()

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            loops = list(self._watched)
            self._watched.clear()
        for lp in loops:
            lp._detach()
        self._ping.set()

    # ------------------------------------------------------------ worker
    def _scan_loop(self) -> None:
        while True:
            self._ping.wait(self._poll_s)
            self._ping.clear()
            with self._lock:
                if self._stop:
                    return
                entries = list(self._watched.items())
            for loop, entry in entries:
                self._scan_one(loop, entry)

    def _scan_one(self, loop: ServingLoop, entry: dict) -> None:
        exc = loop.crashed
        if exc is None:
            # liveness backstop: a loop that should be running but whose
            # thread is gone without a clean exit is dead too (e.g. a
            # thread swallowed into an uninterruptible state and reaped).
            with loop._cond:
                stalled = (loop._state in (LoopState.RUNNING,
                                           LoopState.DRAINING)
                           and loop._threads
                           and not any(t.is_alive() for t in loop._threads)
                           and not loop._clean_exit)
            if not stalled:
                return
            exc = LoopCrashed(f"{loop.name}: loop thread died without "
                              f"a recorded exception")
        if entry["handled_gen"] >= loop.generation:
            return
        entry["handled_gen"] = loop.generation
        loop._finish_crash(exc)
        self.recoveries += 1
        verdict = None
        if entry["on_death"] is not None:
            try:
                verdict = entry["on_death"](loop, exc)
            except Exception:  # noqa: BLE001 - recovery must not die
                verdict = False
        if not entry["restart"] or verdict is False:
            return
        delay = min(entry["backoff_s"] * (2 ** entry["attempts"]),
                    entry["backoff_cap_s"])
        entry["attempts"] += 1
        time.sleep(delay)
        try:
            loop.restart()
        except IllegalLoopTransition:
            pass


_supervisor_lock = threading.Lock()
_supervisor: Optional[LoopSupervisor] = None


def supervisor() -> LoopSupervisor:
    """Process-wide ``LoopSupervisor`` singleton (lazily started)."""
    global _supervisor
    with _supervisor_lock:
        if _supervisor is None:
            _supervisor = LoopSupervisor()
        return _supervisor
