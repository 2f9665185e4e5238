"""Opt-in runtime lock-order assertion (the dynamic half of graftcheck;
the port's own copy of ``deeplearning4j_tpu/analysis/instrument.py``).

The static lock-acquisition graph (``concurrency_rules.check_lock_graph``)
proves the *declared* order is acyclic; this module asserts the order
actually holds at runtime. Every serving lock gets a rank, and acquiring
a lock whose rank is <= one already held by the thread raises
``LockOrderViolation`` naming both locks — a deadlock report BEFORE the
deadlock.

Enable it in tests with the pytest plugin
``-p deeplearning4j_torch.analysis.lock_debug``, which wraps every test in
:func:`install`/:func:`uninstall`. Production code never pays for it —
``install()`` rebinds the lock attributes after construction;
uninstalled classes use plain ``threading`` primitives.

The static order (low acquires first, a thread may only acquire UP), the
JAX package's ranks for the locks the port has:

====  =====================================
rank  lock
====  =====================================
10    StreamingBroker._lock
15    NearestNeighborsServer._lock
18    EmbeddingIndex._lock
20    ParallelInference._lock
25    ServingLoop._cond
30    ParallelInference._drain_cv, GenerationServer._cond,
      EmbeddingIndex._drain_cv
35    ReplicaFleet._cond
38    FleetFederation._cond
40    KerasBackendServer._lock
55    LoopSupervisor._lock
60    AdmissionController._lock
70    CircuitBreaker._lock
80    RetryPolicy._lock
====  =====================================

The serving runtime slots in at 25: servers may touch their ServingLoop
(``begin_drain``/``close``/``put``) while holding a sub-25 lock, but the
servers always call the runtime with NO server lock held — the runtime in
turn invokes its callbacks (tick/handler/wake/on_death) outside
``_cond``, so wake hooks may notify server conditions (rank 30/35)
freely. The retrieval tier ranks lowest of the servers:
``NearestNeighborsServer`` handlers call into ``EmbeddingIndex``
(15 → 18) and the index's locked ``_ensure_workers`` starts/watches
runtime loops (18 → 25 → 55). ``ReplicaFleet._cond`` ranks above the
replica servers' locks because replica completion callbacks run under a
server lock and then take the fleet's. ``LoopSupervisor._lock`` ranks
above every loop and server lock it can be entered under (watch() from a
locked _ensure_workers); the supervisor copies its watch table under
``_lock`` and recovers loops outside it, so it never acquires downward.

JAX's table also ranks ``GenerationServer._trace_lock`` (28), its
class-wide lock around mesh program traces. The port traces no programs
and has no such lock. (In JAX, ``install()`` sets a wrapper on each
new instance, but the server takes the class attribute
``GenerationServer._trace_lock``, never the instance's, so rank 28 is
never checked there either.)

(Serving stats counters live in the per-metric leaf locks of the metrics
registry — metrics/registry.py — which rank strictly last: registry
publication never happens while holding a serving lock, and a scrape
takes no serving lock, so the registry stays out of the ranked set.)
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

_tls = threading.local()

#: the message of every violation raised since the last clear, on any
#: thread — a violation on a loop thread becomes that loop's crash, so
#: callers (the ``lock_debug`` plugin, ``chip_smoke.py``) read it here
violations: List[str] = []


class LockOrderViolation(AssertionError):
    """A thread acquired a lock out of rank order — two threads doing
    this in opposite order is a deadlock."""


def _stack() -> List[Tuple[int, int, str]]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _check_and_push(obj: "OrderedLock") -> None:
    st = _stack()
    held_max = max((r for (_i, r, _n) in st), default=None)
    if held_max is not None and obj.rank <= held_max:
        held = ", ".join(f"{n} (rank {r})" for (_i, r, n) in st)
        msg = (f"acquiring {obj.name} (rank {obj.rank}) while holding "
               f"[{held}] — lock ranks must strictly increase; see "
               "deeplearning4j_torch/analysis/instrument.py for the order")
        violations.append(msg)
        raise LockOrderViolation(msg)
    st.append((id(obj), obj.rank, obj.name))


def _pop(obj: "OrderedLock") -> None:
    st = _stack()
    for i in range(len(st) - 1, -1, -1):
        if st[i][0] == id(obj):
            del st[i]
            return


def _push_unchecked(obj: "OrderedLock") -> None:
    _stack().append((id(obj), obj.rank, obj.name))


class OrderedLock:
    """Rank-checked wrapper over a ``threading.Lock``/``RLock``."""

    def __init__(self, rank: int, name: str, lock=None):
        self.rank = rank
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, *a, **kw) -> bool:
        _check_and_push(self)
        got = self._lock.acquire(*a, **kw)
        if not got:
            _pop(self)
        return got

    def release(self) -> None:
        _pop(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class OrderedCondition(OrderedLock):
    """Rank-checked wrapper over a ``threading.Condition``. ``wait``
    pops the rank for its duration — the condition's lock is released
    while waiting, so holding the rank would false-positive the next
    acquisition on this thread."""

    def __init__(self, rank: int, name: str, cond=None):
        cond = cond if cond is not None else threading.Condition()
        super().__init__(rank, name, cond)
        self._cond = cond

    def wait(self, timeout: Optional[float] = None):
        _pop(self)
        try:
            return self._cond.wait(timeout)
        finally:
            _push_unchecked(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _pop(self)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            _push_unchecked(self)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# ---------------------------------------------------------------------------
# install/uninstall: rebind the serving classes' lock attributes
# ---------------------------------------------------------------------------

#: class -> {attr: (rank, is_condition)}
def _targets() -> Dict[type, Dict[str, Tuple[int, bool]]]:
    from deeplearning4j_torch.modelimport.server import KerasBackendServer
    from deeplearning4j_torch.nearestneighbors.index import EmbeddingIndex
    from deeplearning4j_torch.nearestneighbors.server import (
        NearestNeighborsServer,
    )
    from deeplearning4j_torch.parallel.federation import FleetFederation
    from deeplearning4j_torch.parallel.fleet import ReplicaFleet
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.inference import ParallelInference
    from deeplearning4j_torch.parallel.resilience import (AdmissionController,
                                                        CircuitBreaker,
                                                        RetryPolicy)
    from deeplearning4j_torch.parallel.runtime import (LoopSupervisor,
                                                     ServingLoop)
    from deeplearning4j_torch.streaming.broker import StreamingBroker

    return {
        StreamingBroker: {"_lock": (10, False)},
        NearestNeighborsServer: {"_lock": (15, False)},
        EmbeddingIndex: {"_lock": (18, False), "_drain_cv": (30, True)},
        ParallelInference: {"_lock": (20, False), "_drain_cv": (30, True)},
        ServingLoop: {"_cond": (25, True)},
        GenerationServer: {"_cond": (30, True)},
        ReplicaFleet: {"_cond": (35, True)},
        FleetFederation: {"_cond": (38, True)},
        KerasBackendServer: {"_lock": (40, False)},
        LoopSupervisor: {"_lock": (55, False)},
        AdmissionController: {"_lock": (60, False)},
        CircuitBreaker: {"_lock": (70, False)},
        RetryPolicy: {"_lock": (80, False)},
    }


_originals: List[Tuple[type, object]] = []
#: (weak reference, class name, rank map) of each instance built while
#: installed
_built: List[Tuple[weakref.ref, str, Dict[str, Tuple[int, bool]]]] = []


def install() -> None:
    """Wrap the serving classes' lock attributes in rank-checked
    wrappers (idempotent). New instances constructed after install()
    assert the static lock order on every acquisition."""
    if _originals:
        return
    del _built[:]
    for cls, attrs in _targets().items():
        orig_init = cls.__init__

        def make_init(orig, attr_map, cls_name):
            def __init__(self, *a, **kw):
                orig(self, *a, **kw)
                for attr, (rank, is_cond) in attr_map.items():
                    cur = getattr(self, attr, None)
                    if cur is None or isinstance(cur, OrderedLock):
                        continue
                    name = f"{cls_name}.{attr}"
                    wrapped = (OrderedCondition(rank, name, cur) if is_cond
                               else OrderedLock(rank, name, cur))
                    setattr(self, attr, wrapped)
                _built.append((weakref.ref(self), cls_name, attr_map))
            return __init__

        cls.__init__ = make_init(orig_init, attrs, cls.__name__)
        _originals.append((cls, orig_init))


def uninstall() -> None:
    """Restore the plain constructors (instances already wrapped keep
    their wrappers — they are behaviorally identical minus the check)."""
    while _originals:
        cls, orig = _originals.pop()
        cls.__init__ = orig


def built() -> List[object]:
    """The live instances of the ranked classes built since the last
    :func:`install`."""
    return [obj for obj in (ref() for ref, _n, _m in list(_built))
            if obj is not None]


def unwrapped() -> List[str]:
    """``Class.attr`` of every ranked lock attribute of a live instance
    built since the last :func:`install` that is not rank-checked (never
    wrapped, or rebound to a plain lock after construction)."""
    out = []
    for ref, cls_name, attr_map in list(_built):
        obj = ref()
        if obj is None:
            continue
        out.extend(f"{cls_name}.{attr}" for attr in attr_map
                   if not isinstance(getattr(obj, attr, None), OrderedLock))
    return out
