"""Supervised serving runtime: one lifecycle for every loop thread (the
port's own copy of ``deeplearning4j_tpu/parallel/runtime.py``).

``ServingLoop`` defines the queues, sentinels, drain/close choreography and
crash recovery of the port's serving threads exactly once (the
``ParallelInference`` coalescer/completer pair, the ``GenerationServer``
decode loop and the ``ReplicaFleet`` monitor):

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

Two hosting modes:

* **inbox mode** (``handler=...``): the loop owns a bounded
  ``queue.Queue`` inbox and a pool of worker threads consuming from it.
  One sentinel discipline: ``close()`` puts exactly one ``_SENTINEL``;
  each worker that sees it decrements the live count and re-puts it for
  the next worker, so a single token walks the whole pool down.
* **tick mode** (``tick=...``): the loop owns one thread repeatedly
  calling ``tick()`` until it returns False or the loop leaves RUNNING /
  DRAINING. ``wake`` is called (outside any runtime lock) whenever the
  state machine advances, so a tick body blocked on its own condition
  variable can re-check state promptly.

``LoopSupervisor`` watches registered loops, detects loop-thread death
(a crash recorded by the loop, or the liveness backstop: a RUNNING loop
whose threads are all gone without a clean exit), and runs the uniform
recovery contract: finish the crash (fail leftovers, release waiters),
call the owner's ``on_death`` hook (where servers fail their in-flight
futures with the typed ``LoopCrashed``), and optionally restart the loop
with exponential backoff.

Lock order: ``ServingLoop._cond`` before ``LoopSupervisor._lock``, never
the other way round. The runtime NEVER invokes user callbacks
(``handler``, ``tick``, ``wake``, ``on_leftover``, ``on_worker_exit``,
``on_death``) while holding ``_cond``, and the supervisor never calls
loop methods while holding ``_lock``.

PyTorch's grad mode is per thread: a handler or tick body that runs a
forward enters ``torch.inference_mode()`` itself (the runtime imports no
torch).
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Any, Callable, List, Optional


class LoopError(RuntimeError):
    """Base class for serving-runtime lifecycle errors."""


class IllegalLoopTransition(LoopError):
    """A lifecycle method was called from a state that forbids it."""


class LoopClosed(LoopError):
    """``put()`` (or a handler's downstream put) hit a CLOSED loop."""


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


class _Token:
    """Control token circulated through an inbox (never user data)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<loop-token {self.name}>"


_SENTINEL = _Token("sentinel")   # one per close(); walks the worker pool
_RESIGN = _Token("resign")       # retires exactly one worker
EXIT = _Token("exit")            # handler return value: retire this worker


class ServingLoop:
    """One supervised loop: owned thread(s), bounded inbox, one sentinel
    discipline, and the NEW → RUNNING → DRAINING → CLOSED state machine.

    Exactly one of ``handler`` (inbox mode) or ``tick`` (tick mode) must
    be given. In inbox mode ``handler(item)`` may return:

    * ``None`` — item consumed, get the next one;
    * ``EXIT`` — retire this worker (its slot is gone until
      ``set_workers``/``restart`` respawns it);
    * any other value — a *carried* item handed back as the next input
      (head-of-line carry for batch-boundary flushes).

    In tick mode ``tick()`` returns True to keep running, False to stop
    cleanly; ``wake()`` is invoked when the state machine advances.
    """

    # Runtime-owned state (``_state``, ``_closed_evt``, ``_inbox``,
    # ``_supervisor``) is written only under ``_cond`` by lifecycle
    # methods and read lock-free on loop threads' hot paths.

    def __init__(self, name: str, *,
                 handler: Optional[Callable[[Any], Any]] = None,
                 tick: Optional[Callable[[], bool]] = None,
                 wake: Optional[Callable[[], None]] = None,
                 workers: int = 1,
                 max_workers: Optional[int] = None,
                 inbox: Optional[queue.Queue] = None,
                 inbox_maxsize: int = 0,
                 on_leftover: Optional[Callable[[Any], None]] = None,
                 on_worker_exit: Optional[
                     Callable[["ServingLoop", Optional[BaseException]],
                              None]] = None,
                 chaos: Any = None,
                 daemon: bool = True):
        if (handler is None) == (tick is None):
            raise ValueError("exactly one of handler= or tick= is required")
        self.name = name
        self._handler = handler
        self._tick = tick
        self._wake = wake
        self._daemon = daemon
        self._cond = threading.Condition()
        self._state = LoopState.NEW
        self._workers = max(1, int(workers))
        self._max_workers = max(self._workers,
                                int(max_workers or self._workers))
        self._inbox_maxsize = int(inbox_maxsize)
        self._external_inbox = inbox is not None
        self._inbox: Optional[queue.Queue] = None
        if handler is not None:
            self._inbox = inbox if inbox is not None \
                else queue.Queue(maxsize=self._inbox_maxsize)
        self._on_leftover = on_leftover
        self._on_worker_exit = on_worker_exit
        self._chaos = chaos
        self._threads: List[threading.Thread] = []
        self._live = 0              # workers not yet exited (under _cond)
        self._seq = 0               # worker name sequence
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
        """First exception that took a loop thread down, else None."""
        with self._cond:
            return self._crash_exc

    @property
    def alive_workers(self) -> int:
        with self._cond:
            return self._live

    @property
    def threads(self) -> List[threading.Thread]:
        with self._cond:
            return list(self._threads)

    def stats(self) -> dict:
        with self._cond:
            return {
                "name": self.name,
                "state": self._state.value,
                "workers": self._live,
                "generation": self.generation,
                "restarts": self.restarts,
                "crashed": self._crash_exc is not None,
            }

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
        """Spawn the owned thread(s). Caller holds ``_cond``."""
        self._clean_exit = False
        if self._tick is not None:
            t = threading.Thread(target=self._tick_main, daemon=self._daemon,
                                 name=self.name)
            self._threads.append(t)
            self._live += 1
            t.start()
            return
        for _ in range(self._workers):
            self._spawn_worker_locked()

    def _spawn_worker_locked(self) -> None:
        self._seq += 1
        suffix = "" if self._max_workers == 1 else f"-{self._seq}"
        t = threading.Thread(target=self._worker_main, daemon=self._daemon,
                             name=f"{self.name}{suffix}")
        self._threads.append(t)
        self._live += 1
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
                live = self._live
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
        if self._inbox is not None and live > 0:
            # ONE sentinel walks the whole pool down (each worker re-puts
            # it until the last one retires it). The put is bounded: a
            # full inbox whose workers are already exiting another way
            # (socket error, EXIT) must not block the closer.
            while True:
                with self._cond:
                    if self._live <= 0:
                        break
                try:
                    self._inbox.put(_SENTINEL, timeout=0.05)
                    break
                except queue.Full:
                    if time.monotonic() >= deadline:
                        break
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self.fail_leftovers()
        self._closed_evt.set()
        sup = self._supervisor
        if sup is not None:
            sup.unwatch(self)

    def restart(self) -> "ServingLoop":
        """CLOSED → RUNNING with fresh threads (and a fresh inbox unless
        the inbox is externally owned). Supervisor-driven."""
        with self._cond:
            if self._state is not LoopState.CLOSED:
                raise IllegalLoopTransition(
                    f"{self.name}: restart() from {self._state.value}")
            if self._retired:
                raise IllegalLoopTransition(
                    f"{self.name}: restart() after deliberate close()")
            if self._inbox is not None and not self._external_inbox:
                self._inbox = queue.Queue(maxsize=self._inbox_maxsize)
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

    # ------------------------------------------------------------- inbox
    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        """Enqueue work. Raises ``LoopClosed`` once the loop is CLOSED.
        A put that races close() is recovered: if the state flipped to
        CLOSED after the enqueue, the (idempotent) leftover drain runs
        again so the item is failed, never stranded."""
        if self._inbox is None:
            raise LoopError(f"{self.name} is a tick loop (no inbox)")
        if self._state is LoopState.CLOSED:
            raise LoopClosed(f"{self.name} is closed")
        self._inbox.put(item, timeout=timeout)
        if self._state is LoopState.CLOSED:
            self.fail_leftovers()

    def get(self, timeout: Optional[float] = None) -> Any:
        """Expose the inbox to batching handlers (raises ``queue.Empty``).
        Control tokens are never returned: a handler pulling extra items
        to extend a batch must not swallow the pool's sentinel."""
        if self._inbox is None:
            raise LoopError(f"{self.name} is a tick loop (no inbox)")
        item = self._inbox.get(timeout=timeout)
        if isinstance(item, _Token):
            self._inbox.put(item)
            raise queue.Empty()
        return item

    def set_workers(self, n: int) -> int:
        """Scale the worker pool within [1, max_workers]; surplus workers
        are retired via one ``_RESIGN`` token each."""
        if self._inbox is None:
            raise LoopError(f"{self.name} is a tick loop (no pool)")
        n = max(1, min(int(n), self._max_workers))
        spawn = resign = 0
        with self._cond:
            if self._state is not LoopState.RUNNING:
                return self._workers
            self._workers = n
            if n > self._live:
                spawn = n - self._live
                for _ in range(spawn):
                    self._spawn_worker_locked()
            elif n < self._live:
                resign = self._live - n
        for _ in range(resign):
            self._inbox.put(_RESIGN)
        return n

    def fail_leftovers(self) -> int:
        """Drain the inbox, handing every non-token item to
        ``on_leftover``. Idempotent; safe from any thread once the loop
        is CLOSED (or crashing)."""
        if self._inbox is None:
            return 0
        n = 0
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                return n
            if isinstance(item, _Token):
                continue
            n += 1
            if self._on_leftover is not None:
                self._on_leftover(item)

    # ------------------------------------------------------ thread mains
    def _worker_main(self) -> None:
        exc: Optional[BaseException] = None
        try:
            self._consume()
        except BaseException as e:  # noqa: BLE001 - crash recording
            exc = e
        finally:
            self._retire(exc)

    def _consume(self) -> None:
        inbox = self._inbox
        head: Any = None
        while True:
            item = head if head is not None else inbox.get()
            head = None
            if item is _SENTINEL:
                chaos = self._chaos
                if chaos is not None:
                    fault = getattr(chaos, "sentinel_fault", None)
                    if fault is not None:
                        fault()
                with self._cond:
                    last = self._live <= 1
                if not last:
                    inbox.put(_SENTINEL)
                return
            if item is _RESIGN:
                return
            if self._state is LoopState.DRAINING:
                chaos = self._chaos
                if chaos is not None:
                    fault = getattr(chaos, "drain_fault", None)
                    if fault is not None:
                        fault()
            out = self._handler(item)
            if out is EXIT:
                return
            head = out

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
        """Common worker/tick exit path: drop the live count, surface the
        exit to the owner, record a crash for the supervisor. Any
        exception-free exit (sentinel, resign, EXIT, tick False) marks
        the loop clean so the supervisor's liveness backstop never
        mistakes a deliberately retired pool for a dead one."""
        with self._cond:
            self._live -= 1
            if exc is None:
                self._clean_exit = True
            self._cond.notify_all()
        if self._on_worker_exit is not None:
            try:
                self._on_worker_exit(self, exc)
            except Exception:  # noqa: BLE001 - exit hooks must not recurse
                pass
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
        """Supervisor-driven crash completion: force CLOSED, walk any
        surviving workers out with ``_RESIGN`` (no sentinel re-put — a
        crashed producer must not shut down a healthy downstream loop),
        fail leftovers, release close() waiters. Returns False when the
        crash was already handled (idempotent)."""
        with self._cond:
            if self._crash_handled:
                return False
            self._crash_handled = True
            if self._crash_exc is None:
                self._crash_exc = exc
            already_closed = self._state is LoopState.CLOSED
            self._state = LoopState.CLOSED
            self._cond.notify_all()
            live = self._live
        if self._wake is not None:
            self._wake()
        if self._inbox is not None:
            for _ in range(max(0, live)):
                self._inbox.put(_RESIGN)
        self.fail_leftovers()
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

    1. ``loop._finish_crash(exc)`` — force CLOSED, retire survivors,
       fail leftover inbox items (typed, via the loop's ``on_leftover``).
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
            # threads are all gone without a clean exit is dead too
            # (e.g. a worker swallowed into an uninterruptible state and
            # the interpreter reaped it).
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
