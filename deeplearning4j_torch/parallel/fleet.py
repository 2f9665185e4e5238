"""ReplicaFleet: a health-routed front end over N independent model
replicas with one ``submit() -> Future`` surface (the port of
``deeplearning4j_tpu/parallel/fleet.py``).

Data-parallel *serving*, the reproduction of the reference stack's
layer-4 reason-to-exist (ParallelWrapper / parameter-server replicas): one
sick or crashed replica sheds load into the rest of the fleet instead of
taking the service down. Replicas may share one card: each
``GenerationServer`` owns its own KV page pool, and their loop threads
launch on the card's default stream in turn.

Topology::

    submit() -> Future
        |
    ReplicaFleet ------------- monitor thread (redispatch, hedging,
        |   routing: weighted     supervised restart w/ backoff)
        |   least-loaded over
        |   healthy replicas
        +-- replica 0: CircuitBreaker + AdmissionController + server
        +-- replica 1: CircuitBreaker + AdmissionController + server
        +-- ...            (GenerationServer or ParallelInference)

Invariants:

- **Zero lost futures across replica death.** Every accepted request
  either resolves with a result or fails with a typed error from the
  ``resilience`` taxonomy. When a replica dies mid-request (chaos kill,
  crash, abrupt close), its in-flight and queued requests are re-submitted
  to a surviving replica. Because generation sampling derives every
  token's key from ``fold_in(PRNGKey(seed), token_index)`` — never from
  server state — a re-dispatched request regenerates the *bit-exact* same
  completion on any replica.
- **Lock order.** Replica servers invoke our completion callbacks while
  holding their own internal locks, so the only permitted order is
  ``server lock -> fleet._cond``. The fleet therefore never calls into a
  replica server (submit/drain/close/stats) while holding ``_cond``; all
  re-dispatch, hedging, and restart work is done by the monitor thread
  outside the lock.
- **Typed load shedding at submit.** A fresh submit with no routable
  replica fails fast — ``ReplicaUnavailable`` when every replica is
  dead/restarting/draining, ``CircuitOpen`` when the survivors' breakers
  are all open, ``ServerOverloaded`` when every replica rejected the
  request at admission — rather than queueing behind a fleet that cannot
  make progress. Only *accepted* work is parked for re-dispatch.

Hedging (optional): when a request's newest attempt has been running
longer than ``hedge_after_s``, the monitor launches a duplicate on a
different healthy replica; the first result wins and the loser is
cancelled. This bounds straggler-replica tail latency at the cost of
duplicated work.

Disaggregated tiers (optional, ``roles=``): DistServe/Splitwise-style
prefill/decode separation behind the same ``submit() -> Future``. A
fresh request routes to a prefill-capable replica, which runs chunked
wave prefill and resolves the attempt with a **KVSnapshot** instead of
tokens; the fleet stages the snapshot and re-routes it onto the decode
tier, where ``adopt_request`` resumes it at its exact stream position.
The caller's future only ever resolves with final tokens. TTFT (submit
-> first prefilled token) and inter-token latency land in separate
registry histograms (``fleet_ttft_ms`` / ``fleet_itl_ms``). When the
decode tier has no READY replica the fleet enters **degraded mode** —
co-located serving on the prefill tier (fresh submits are pinned
``export_kv=False``, staged snapshots adopt in place) — and recovers
automatically when a decode-capable replica heals.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.parallel.handoff import KVSnapshot, SnapshotError
from deeplearning4j_torch.parallel.mesh import MeshGeometryError, local_devices
from deeplearning4j_torch.parallel.resilience import (
    AdmissionController, CircuitBreaker, CircuitOpen, Deadline,
    DeadlineExceeded, ReplicaKilled, ReplicaUnavailable, ResilienceError,
    ServerOverloaded)
from deeplearning4j_torch.parallel.runtime import (LoopCrashed, LoopState,
                                                   ServingLoop, supervisor)

log = logging.getLogger(__name__)

# Replica lifecycle: SPAWNING -> WARMING -> READY -> (DRAINING -> RETIRED
# | DEAD -> SPAWNING ...). Only READY replicas take traffic; DEAD ones are
# respawned by the monitor after their backoff; RETIRED ones never return.
SPAWNING = "spawning"
WARMING = "warming"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"
RETIRED = "retired"

_EWMA_FLOOR_MS = 0.5  # score floor so a fresh replica isn't infinitely hot


def device_groups(n_groups: int, tp: int, devices=None) -> list:
    """Partition the device pool into ``n_groups`` disjoint lists of
    ``tp`` devices — one tensor-parallel replica group per fleet replica.
    ``devices`` defaults to every CUDA device
    (``torch.cuda.device_count()``). The factory idiom::

        groups = device_groups(2, tp=4)
        fleet = ReplicaFleet(lambda rid: GenerationServer(
            net, vocab, mesh=model_mesh(4, devices=groups[rid % 2])),
            replicas=2)

    Groups are disjoint by construction (by entry: a pool naming one
    device several times yields groups of those entries) so two replicas
    never contend for a card; validation is loud (``MeshGeometryError``)
    because a short group would silently shrink the page budget the
    replica admits against."""
    if devices is None:
        devices = local_devices()
    if n_groups < 1 or tp < 1:
        raise MeshGeometryError(
            f"need n_groups >= 1 and tp >= 1, got {n_groups}x{tp}")
    need = n_groups * tp
    if need > len(devices):
        raise MeshGeometryError(
            f"{n_groups} replica groups x tp={tp} needs {need} devices, "
            f"have {len(devices)}")
    return [list(devices[g * tp:(g + 1) * tp]) for g in range(n_groups)]


class _Replica:
    """Mutable per-replica record. No lock of its own — every field is
    read and written only under the owning fleet's ``_cond`` (``server``,
    ``rid``, ``generation``, ``breaker``, ``admission`` are written once
    at construction and safe to read anywhere)."""

    __slots__ = ("rid", "generation", "server", "breaker", "admission",
                 "role", "state", "inflight", "ewma_ms", "fail_ewma",
                 "restarts", "spawn_failures", "backoff_s", "restart_at",
                 "dispatched", "completed", "failed", "rejected",
                 "prior_trips")

    def __init__(self, rid: int, generation: int, server: Any,
                 breaker: CircuitBreaker, admission: AdmissionController,
                 backoff_s: float, role: str = "unified"):
        self.rid = rid
        self.generation = generation
        self.server = server
        self.breaker = breaker
        self.admission = admission
        self.role = role
        self.state = READY
        self.inflight = 0
        self.ewma_ms = 0.0
        self.fail_ewma = 0.0
        self.restarts = 0
        self.spawn_failures = 0
        self.backoff_s = backoff_s
        self.restart_at = 0.0
        self.dispatched = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.prior_trips = 0  # breaker trips accumulated by retired breakers


def _score(r: _Replica) -> float:
    """Weighted least-loaded health score — lower routes first. Queue
    depth multiplies expected latency (EWMA); the recent-failure EWMA
    inflates the score so a flapping replica cools off even while its
    breaker is still closed."""
    ewma = r.ewma_ms if r.ewma_ms > _EWMA_FLOOR_MS else _EWMA_FLOOR_MS
    return (r.inflight + 1.0) * ewma * (1.0 + 8.0 * r.fail_ewma)


class _FleetRequest:
    """One accepted request: the original call (so a re-dispatch replays
    it identically — the fold_in key schedule then makes the regenerated
    completion bit-exact) plus routing state. Mutable fields are guarded
    by the fleet's ``_cond``."""

    __slots__ = ("args", "kwargs", "deadline", "future", "resolved",
                 "active", "tried", "attempts", "hedges", "t_dispatch",
                 "last_error", "snapshot", "t_submit", "t_first", "tier")

    def __init__(self, args: tuple, kwargs: dict,
                 deadline: Optional[Deadline], future: Future,
                 tier: Optional[str] = None):
        self.args = args
        self.kwargs = kwargs
        self.deadline = deadline
        self.future = future
        self.tier = tier  # role-pinned routing (RAG knn/generate tiers)
        self.t_submit = time.monotonic()
        self.t_first = 0.0  # when the fleet first saw a token (TTFT)
        self.resolved = False
        self.active: Dict[int, Future] = {}  # rid -> in-flight inner future
        self.tried: set = set()
        self.attempts = 0
        self.hedges = 0
        self.t_dispatch = 0.0
        self.last_error: Optional[BaseException] = None
        # newest KV snapshot harvested off a failed attempt's future:
        # the next dispatch ADOPTS it (resume at position N) instead of
        # regenerating from token 0
        self.snapshot = None


class ReplicaFleet:
    """Route ``submit()`` traffic over ``replicas`` independent servers
    built by ``factory(rid)`` — anything with the serving contract
    ``submit(*args, deadline_s=..., **kwargs) -> Future``, ``drain``,
    ``close``, ``stats`` (``GenerationServer`` and ``ParallelInference``
    both qualify).

    ``hedge_after_s`` enables straggler hedging; ``restart=False``
    disables supervised restart (dead replicas stay dead); ``warmup`` is
    an optional callable run on every freshly spawned server before it
    takes traffic (e.g. a canary request that pre-compiles programs).

    ``roles`` (one of ``"prefill"``/``"decode"``/``"unified"`` per
    replica, rid-indexed) turns on disaggregated tier routing — see the
    module docstring. The factory must build a server matching the
    declared role (``GenerationServer(role=...)``); supervised restart
    rebuilds the same rid with the same role.
    """

    def __init__(self, factory: Callable[[int], Any], replicas: int = 2, *,
                 max_pending: int = 256, replica_max_pending: int = 64,
                 hedge_after_s: Optional[float] = None, max_hedges: int = 1,
                 max_redispatch: Optional[int] = None,
                 restart: bool = True, restart_backoff_s: float = 0.05,
                 restart_backoff_cap_s: float = 2.0,
                 warmup: Optional[Callable[[Any], None]] = None,
                 breaker_factory: Optional[Callable[[], CircuitBreaker]]
                 = None,
                 health_alpha: float = 0.25, tick_s: float = 0.005,
                 registry: Optional[MetricsRegistry] = None,
                 roles: Optional[Sequence[str]] = None,
                 chaos: Any = None):
        if int(replicas) < 1:
            raise ValueError("need at least one replica")
        if roles is not None:
            roles = tuple(roles)
            if len(roles) != int(replicas):
                raise ValueError(
                    f"roles must name one role per replica "
                    f"({int(replicas)}), got {len(roles)}")
            bad = sorted({x for x in roles
                          if x not in ("unified", "prefill", "decode",
                                       "knn", "generate")})
            if bad:
                raise ValueError(f"unknown replica roles {bad!r}")
            if any(x in ("prefill", "decode") for x in roles):
                if not any(x in ("prefill", "unified") for x in roles):
                    raise ValueError("a tiered fleet needs at least one "
                                     "prefill-capable replica")
                if not any(x in ("decode", "unified") for x in roles):
                    raise ValueError("a tiered fleet needs at least one "
                                     "decode-capable replica")
        self._roles = roles
        self._factory = factory
        self._warmup = warmup
        self._breaker_factory = breaker_factory
        self._replica_max_pending = int(replica_max_pending)
        self._hedge_after_s = (None if hedge_after_s is None
                               else float(hedge_after_s))
        self._max_hedges = max(0, int(max_hedges))
        self._max_redispatch = (None if max_redispatch is None
                                else int(max_redispatch))
        self._restart = bool(restart)
        self._restart_backoff_s = float(restart_backoff_s)
        self._restart_backoff_cap_s = float(restart_backoff_cap_s)
        self._alpha = float(health_alpha)
        self._tick_s = float(tick_s)
        self.admission = AdmissionController(max_pending=max_pending)

        self._cond = threading.Condition()
        self._pending: deque = deque()   # parked _FleetRequests (redispatch)
        self._inflight_reqs: set = set()  # every unresolved _FleetRequest
        self._replicas: List[_Replica] = []
        # distinguishes a deliberate close() from a monitor crash: the
        # supervisor only restarts the monitor loop when this is False
        self._user_close = False
        self._chaos = chaos
        self._degraded = False  # decode tier dark -> co-located serving
        # fleet-wide aggregates live in the (leaf-locked) registry: the
        # routing path and completion callbacks publish without holding
        # _cond, and a scrape never contends with routing. Per-replica
        # traffic fields stay plain on _Replica, guarded by _cond.
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        m = self.metrics
        self._m_submitted = m.counter(
            "fleet_submitted_total", "requests offered to the fleet")
        self._m_rejected_submits = m.counter(
            "fleet_rejected_submits_total",
            "submits shed typed before acceptance")
        self._m_completed = m.counter(
            "fleet_completed_total", "requests completed")
        self._m_failed = m.counter(
            "fleet_failed_total", "requests failed on error")
        self._m_expired = m.counter(
            "fleet_expired_total", "requests failed on deadline")
        self._m_redispatched = m.counter(
            "fleet_redispatched_total",
            "attempts re-parked after a replica failure")
        self._m_hedged = m.counter(
            "fleet_hedged_total", "straggler hedge attempts launched")
        self._m_losers_cancelled = m.counter(
            "fleet_losers_cancelled_total",
            "duplicate attempts cancelled after a winner")
        self._m_deaths = m.counter(
            "fleet_deaths_total", "replica deaths observed")
        self._m_restarts = m.counter(
            "fleet_restarts_total", "supervised replica restarts")
        self._m_handoff_resumes = m.counter(
            "fleet_handoff_resumes_total",
            "redispatches resumed from an adopted KV snapshot")
        self._m_handoff_fallbacks = m.counter(
            "fleet_handoff_fallbacks_total",
            "snapshots dropped (invalid/unsupported) for token-0 "
            "regeneration")
        self._m_tier_handoffs = m.counter(
            "fleet_tier_handoffs_total",
            "prefill->decode KVSnapshot handoffs staged by the tier "
            "pipeline")
        self._m_degraded_submits = m.counter(
            "fleet_degraded_submits_total",
            "requests served co-located on the prefill tier while the "
            "decode tier was dark")
        # TTFT vs inter-token latency are *separate* SLOs in a
        # disaggregated topology: prefill capacity bounds the first,
        # decode capacity the second. Keep them in separate histograms.
        self.ttft_hist = m.histogram(
            "fleet_ttft_ms", "time from submit to first token (ms)")
        self.itl_hist = m.histogram(
            "fleet_itl_ms", "mean inter-token latency per request (ms)")
        m.gauge("fleet_degraded_mode",
                "1 while the decode tier has no READY replica and the "
                "fleet serves co-located on the prefill tier",
                fn=lambda: 1.0 if self._degraded else 0.0)
        m.gauge("fleet_replicas", "replica slots in the fleet",
                fn=lambda: len(self._replicas))
        m.gauge("fleet_parked", "requests parked for re-dispatch",
                fn=lambda: len(self._pending))
        m.gauge("fleet_inflight", "unresolved accepted requests",
                fn=lambda: len(self._inflight_reqs))
        m.gauge("fleet_pending", "admission high-watermark occupancy",
                fn=lambda: self.admission.pending)
        m.gauge("fleet_accepted", "requests accepted by fleet admission",
                fn=lambda: self.admission.accepted)
        m.gauge("fleet_rejected", "requests rejected by fleet admission",
                fn=lambda: self.admission.rejected)

        for rid in range(int(replicas)):
            server = factory(rid)  # spawn errors propagate at construction
            if warmup is not None:
                warmup(server)
            self._replicas.append(self._new_replica(rid, 0, server))
        self._tiered = any(r.role != "unified" for r in self._replicas)
        # staged prefill->decode pipeline semantics (KVSnapshot staging,
        # degraded mode, colocated fallback) apply only to the disagg
        # roles; role-pinned tiers ("knn"/"generate" — the RAG pipeline)
        # route by submit(tier=...) and resolve directly
        self._staged = any(r.role in ("prefill", "decode")
                           for r in self._replicas)

        self._runtime = ServingLoop("fleet-monitor",
                                    tick=self._monitor_tick,
                                    wake=self._wake_monitor, chaos=chaos)
        self._runtime.start()
        supervisor().watch(self._runtime, on_death=self._on_monitor_death,
                           restart=True)

    # -- lifecycle state -----------------------------------------------
    @property
    def _closing(self) -> bool:
        """True once the lifecycle left RUNNING (draining or closed)."""
        return self._runtime.state in (LoopState.DRAINING, LoopState.CLOSED)

    @property
    def _stop(self) -> bool:
        return self._runtime.state is LoopState.CLOSED

    # -- construction helpers ------------------------------------------

    def _new_replica(self, rid: int, generation: int,
                     server: Any) -> _Replica:
        if self._breaker_factory is not None:
            breaker = self._breaker_factory()
        else:
            breaker = CircuitBreaker(failure_threshold=0.5, window=16,
                                     min_calls=6, reset_timeout_s=0.25)
        admission = AdmissionController(
            max_pending=self._replica_max_pending)
        srole = getattr(server, "role", None)
        if self._roles is not None:
            role = self._roles[rid]
            if srole is not None and srole != role:
                raise ValueError(
                    f"replica {rid}: fleet roles[{rid}]={role!r} but the "
                    f"factory built a {srole!r} server")
        else:
            role = srole if srole is not None else "unified"
        return _Replica(rid, generation, server, breaker, admission,
                        self._restart_backoff_s, role=role)

    # -- public surface ------------------------------------------------

    def __enter__(self) -> "ReplicaFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def replica_count(self) -> int:
        with self._cond:
            return len(self._replicas)

    def submit(self, *args, deadline_s: Optional[float] = None,
               tier: Optional[str] = None, **kwargs) -> Future:
        """Route one request to the healthiest replica. Returns a Future
        that resolves with the replica's result, survives replica death
        via re-dispatch, and fails only with a typed error. Raises
        ``ServerOverloaded`` / ``CircuitOpen`` / ``ReplicaUnavailable``
        synchronously when the fleet cannot accept the request.

        ``tier`` pins the request to replicas of one role (exact match
        — the RAG pipeline routes retrieval to its ``"knn"`` tier and
        generation to its ``"generate"`` tier this way). A pinned
        request never falls back cross-tier: with no READY replica in
        the tier it sheds ``ReplicaUnavailable`` (fresh submit) or
        parks for re-dispatch (accepted work)."""
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        with self._cond:
            if self._closing:
                raise RuntimeError("ReplicaFleet is closed")
            if tier is not None and not any(r.role == tier
                                            for r in self._replicas):
                raise ValueError(f"no replica fills tier {tier!r}")
        self.admission.acquire()  # fleet-wide high-watermark (429)
        fut = Future()
        fut.add_done_callback(lambda _f: self.admission.release())
        freq = _FleetRequest(
            args, kwargs,
            None if deadline_s is None else Deadline(deadline_s), fut,
            tier=tier)
        with self._cond:
            self._inflight_reqs.add(freq)
        self._m_submitted.inc()
        try:
            routed, reason = self._route_once(freq)
        except ValueError:
            # caller error (bad prompt/shape): fail sync, like the servers
            self._resolve(freq, None, None)  # unlink + release admission
            raise
        if routed:
            return fut
        exc = self._unrouted_error(freq, reason)
        self._resolve(freq, None, exc, rejected=True)
        raise exc

    def _unrouted_error(self, freq: _FleetRequest,
                        reason: str) -> Exception:
        """The typed submit-time shed for a request no replica took."""
        if reason == "breaker":
            return CircuitOpen(
                "every healthy replica's circuit breaker is open")
        if reason == "rejected" and isinstance(freq.last_error,
                                               ResilienceError):
            return freq.last_error
        return ReplicaUnavailable(
            "no replica can accept the request (all dead, draining, "
            "or restarting)")

    def adopt(self, snapshot: KVSnapshot, *,
              deadline_s: Optional[float] = None) -> Future:
        """Accept a harvested ``KVSnapshot`` as a brand-new fleet
        request: the next dispatch resumes it at position N on the
        healthiest (decode-capable) replica via ``adopt_request``, with
        the token-0 fallback replaying the original call reconstructed
        from the snapshot header — bit-exact either way (the fold_in
        key schedule makes regeneration exact), the snapshot only saves
        the recompute. The deadline follows the handoff precedence: an
        explicit ``deadline_s`` wins, else the snapshot's
        ``deadline_remaining`` duration re-arms here (monotonic-deadline
        rule — it survives wall-clock skew between hosts), else no
        deadline. This is the entry the cross-host federation uses to
        re-home a dead host's in-flight requests on a surviving fleet."""
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if deadline_s is None and snapshot.deadline_remaining is not None:
            # expired-in-flight budgets still dispatch once: the typed
            # DeadlineExceeded must come from the routing path, not a
            # constructor ValueError the wire protocol can't express
            deadline_s = max(0.001, snapshot.deadline_remaining)
        args = (snapshot.prompt, snapshot.max_tokens)
        kwargs = {"temperature": snapshot.temperature,
                  "top_k": snapshot.top_k, "seed": snapshot.seed,
                  "eos_id": snapshot.eos_id}
        with self._cond:
            if self._closing:
                raise RuntimeError("ReplicaFleet is closed")
        self.admission.acquire()  # fleet-wide high-watermark (429)
        fut = Future()
        fut.add_done_callback(lambda _f: self.admission.release())
        freq = _FleetRequest(
            args, kwargs,
            None if deadline_s is None else Deadline(deadline_s), fut)
        freq.snapshot = snapshot
        with self._cond:
            self._inflight_reqs.add(freq)
        self._m_submitted.inc()
        try:
            routed, reason = self._route_once(freq)
        except ValueError:
            self._resolve(freq, None, None)  # unlink + release admission
            raise
        if routed:
            return fut
        exc = self._unrouted_error(freq, reason)
        self._resolve(freq, None, exc, rejected=True)
        raise exc

    def kill_replica(self, rid: int) -> bool:
        """Abruptly kill one replica (ops drill / chaos hook): its server
        is closed with a zero drain budget, every request it held fails
        typed and re-dispatches to the survivors, and the monitor respawns
        it after the restart backoff."""
        with self._cond:
            rep = self._replicas[rid]
            if rep.state in (DEAD, RETIRED):
                return False
            rep.state = DEAD
            rep.restart_at = time.monotonic() + rep.backoff_s
            server = rep.server
            self._cond.notify_all()
        self._m_deaths.inc()
        try:
            server.close(timeout=0.0)
        except Exception:
            pass
        return True

    def retire_replica(self, rid: int,
                       timeout: Optional[float] = 30.0, *,
                       migrate: bool = False) -> bool:
        """Gracefully drain one replica and take it out of the fleet for
        good (scale-down). Returns False if it was not READY.

        ``migrate=True`` moves live requests off the replica instead of
        waiting them out: the server snapshots each in-flight request
        and fails it ``RequestMigrated`` with the snapshot attached, and
        the monitor resumes every one on a surviving replica at its
        exact stream position (servers without a migrate-capable
        ``drain`` fall back to the plain wait-out drain)."""
        with self._cond:
            rep = self._replicas[rid]
            if rep.state != READY:
                return False
            rep.state = DRAINING
            server = rep.server
        try:
            if migrate:
                try:
                    server.drain(timeout, migrate=True)
                except TypeError:  # server predates drain(migrate=...)
                    server.drain(timeout)
            else:
                server.drain(timeout)
            server.close(timeout=5.0)
        except Exception:
            pass
        with self._cond:
            if self._replicas[rid] is rep:
                rep.state = RETIRED
            self._cond.notify_all()
        return True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted request has resolved (or the
        timeout passes). New submits are still accepted while draining —
        pair with ``close()`` for shutdown."""
        dl = None if timeout is None else Deadline(timeout)
        with self._cond:
            while self._inflight_reqs or self._pending:
                if dl is not None and dl.expired():
                    return False
                wait_s = self._tick_s * 10.0
                if dl is not None:
                    rem = dl.remaining()
                    if rem < wait_s:
                        wait_s = rem if rem > 0.001 else 0.001
                self._cond.wait(timeout=wait_s)
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, give in-flight requests ``timeout``
        seconds to finish (re-dispatch keeps running), then stop the
        monitor, close every replica, and fail any stragglers typed.
        Idempotent."""
        already = self._stop
        with self._cond:
            # before the drain begins, so a chaos kill landing mid-drain
            # cannot win a restart race against this deliberate close
            self._user_close = True
        self._runtime.begin_drain()   # submit() now rejects typed
        if not already:
            self.drain(timeout)
        self._runtime.close(5.0)
        with self._cond:
            reps = list(self._replicas)
        for rep in reps:
            try:
                rep.server.close(timeout=1.0)
            except Exception:
                pass
        with self._cond:
            for rep in reps:
                if rep.state not in (RETIRED,):
                    rep.state = RETIRED
            leftovers = list(self._inflight_reqs)
            leftovers.extend(self._pending)
            self._pending.clear()
        closed_exc = RuntimeError(
            "ReplicaFleet closed with the request still in flight")
        for freq in leftovers:
            self._resolve(freq, None, closed_exc)

    def stats(self) -> dict:
        with self._cond:
            reps = list(self._replicas)
            parked = len(self._pending)
            inflight = len(self._inflight_reqs)
            degraded = self._degraded
            per = []
            for r in reps:
                per.append({
                    "rid": r.rid,
                    "state": r.state,
                    "role": r.role,
                    "generation": r.generation,
                    "health_score": _score(r),
                    "ewma_latency_ms": r.ewma_ms,
                    "failure_ewma": r.fail_ewma,
                    "inflight": r.inflight,
                    "restarts": r.restarts,
                    "spawn_failures": r.spawn_failures,
                    "dispatched": r.dispatched,
                    "completed": r.completed,
                    "failed": r.failed,
                    "rejected": r.rejected,
                })
        # aggregate counters come off the registry — assembled OUTSIDE
        # _cond — and the legacy key set/order is preserved byte-for-byte
        out = {
            "replica_count": len(reps),
            "submitted": int(self._m_submitted.value),
            "rejected_submits": int(self._m_rejected_submits.value),
            "completed": int(self._m_completed.value),
            "failed": int(self._m_failed.value),
            "expired": int(self._m_expired.value),
            "redispatched": int(self._m_redispatched.value),
            "hedged": int(self._m_hedged.value),
            "losers_cancelled": int(self._m_losers_cancelled.value),
            "deaths": int(self._m_deaths.value),
            "restarts": int(self._m_restarts.value),
            "parked": parked,
            "inflight": inflight,
            "handoff_resumes": int(self._m_handoff_resumes.value),
            "handoff_fallbacks": int(self._m_handoff_fallbacks.value),
        }
        # server/breaker/admission calls take their own locks: keep them
        # outside _cond (replica callbacks already hold server locks when
        # they take _cond, so the reverse order would be a lock cycle)
        for blk, r in zip(per, reps):
            blk["breaker"] = r.breaker.state
            blk["breaker_trips"] = r.prior_trips + r.breaker.open_count
            blk["admission"] = {"pending": r.admission.pending,
                                "accepted": r.admission.accepted,
                                "rejected": r.admission.rejected}
            try:
                blk["server"] = r.server.stats()
            except Exception:
                blk["server"] = None
        out["admission"] = {"pending": self.admission.pending,
                            "accepted": self.admission.accepted,
                            "rejected": self.admission.rejected,
                            "max_pending": self.admission.max_pending}
        out["replicas"] = per
        # disaggregation keys append AFTER the legacy set
        out["tier_handoffs"] = int(self._m_tier_handoffs.value)
        out["degraded_submits"] = int(self._m_degraded_submits.value)
        out["degraded_mode"] = degraded
        if self._tiered:
            tiers: Dict[str, dict] = {}
            for blk, r in zip(per, reps):
                t = tiers.setdefault(r.role, {
                    "replicas": 0, "ready": 0, "inflight": 0,
                    "dispatched": 0, "completed": 0, "failed": 0})
                t["replicas"] += 1
                t["ready"] += 1 if blk["state"] == READY else 0
                t["inflight"] += blk["inflight"]
                t["dispatched"] += blk["dispatched"]
                t["completed"] += blk["completed"]
                t["failed"] += blk["failed"]
            out["tiers"] = tiers
        return out

    # -- per-tier levers (autoscaler surface) --------------------------

    def tier_replicas(self, role: str) -> List[Any]:
        """READY servers currently filling ``role`` (exact match)."""
        with self._cond:
            return [r.server for r in self._replicas
                    if r.role == role and r.state == READY]

    def tier_stats(self, role: str) -> dict:
        """Aggregate queue/outcome counters over one tier's READY
        replica servers — the observation surface for a per-tier
        ``FleetTierTarget`` autoscaler lever. Server stats() calls take
        server locks, so this never holds ``_cond`` across them."""
        out = {"replicas": 0, "queued": 0, "expired": 0, "completed": 0,
               "active_slots": 0, "slots": 0}
        for server in self.tier_replicas(role):
            try:
                st = server.stats()
            except Exception:
                continue
            out["replicas"] += 1
            for k in ("queued", "expired", "completed", "slots"):
                out[k] += st.get(k, 0)
            out["active_slots"] += getattr(server, "active_slot_cap", 0)
        return out

    def set_tier_active_slots(self, role: str, n: int) -> int:
        """Set the active-slot admission cap on every READY replica of
        one tier (the per-tier scaling lever: prefill and decode
        capacity move independently). Returns the applied per-replica
        cap, or 0 when the tier has no capable READY replica."""
        applied = 0
        for server in self.tier_replicas(role):
            if hasattr(server, "set_active_slots"):
                applied = server.set_active_slots(n)
        return applied

    # -- routing core (hot path) ---------------------------------------

    def _tier_route(self, freq: _FleetRequest,
                    skip: set) -> Tuple[List[_Replica], bool]:
        """Tier-aware candidate filter (called under ``_cond``). Stage 1 (no
        snapshot staged) prefers prefill-capable replicas; stage 2
        (snapshot in hand) prefers decode-capable ones. When the decode
        tier has no READY replica anywhere, flips degraded mode and
        returns ``colocate=True`` for fresh requests so the dispatch
        pins ``export_kv=False`` — co-located serving on the prefill
        tier instead of exporting snapshots nobody can adopt. A dark
        *preferred* tier otherwise degrades to any READY replica."""
        ready = [r for r in self._replicas
                 if r.state == READY and r.rid not in skip
                 and r.rid not in freq.active]
        if freq.tier is not None:
            # role-pinned request (RAG tier route): exact-role match
            # only, no cross-tier fallback — a knn query cannot run on
            # a generation replica
            return [r for r in ready if r.role == freq.tier], False
        if not self._staged:
            return ready, False
        stage2 = freq.snapshot is not None
        want = ("decode", "unified") if stage2 else ("prefill", "unified")
        cands = [r for r in ready if r.role in want]
        # tier darkness is fleet-wide readiness, not the skip-filtered
        # view: a replica we merely already tried must not fake a dark
        # tier
        decode_dark = not any(
            r.state == READY and r.role in ("decode", "unified")
            for r in self._replicas)
        if decode_dark:
            self._note_degraded(True)
        if not cands:
            cands = ready  # preferred tier dark: cross-tier fallback
        return cands, decode_dark and not stage2

    def _note_degraded(self, dark: bool) -> None:
        """Flip the degraded-mode flag (``_cond`` held). The typed
        transition log fires once per flip, not once per request."""
        if dark == self._degraded:
            return
        self._degraded = dark
        if dark:
            log.warning(
                "fleet degraded mode ENTERED: decode tier has no READY "
                "replica; serving co-located on the prefill tier")
        else:
            log.warning(
                "fleet degraded mode cleared: decode tier healthy again")

    def _route_once(self, freq: _FleetRequest,
                    hedge: bool = False) -> Tuple[bool, str]:
        """Try to dispatch ``freq`` to the best replica right now.
        Returns ``(True, "dispatched")`` when an attempt is in flight (or
        the request resolved), else ``(False, reason)`` with reason one of
        ``"noreplica"`` (nothing READY), ``"breaker"`` (READY but every
        breaker open), ``"rejected"`` (every candidate refused at
        admission/submit). ValueError from the server (caller error)
        propagates. Never called with ``_cond`` held."""
        skip: set = set()
        saw_breaker_block = False
        saw_rejection = False
        while True:
            with self._cond:
                if freq.resolved or freq.future.cancelled():
                    return True, "dispatched"
                if freq.deadline is not None and freq.deadline.expired():
                    expired = True
                else:
                    expired = False
                rep = None
                colocate = False
                if not expired:
                    cands, colocate = self._tier_route(freq, skip)
                    if cands:
                        fresh = [r for r in cands
                                 if r.rid not in freq.tried]
                        pool = fresh if fresh else cands
                        best = min(pool, key=_score)
                        if best.breaker.allow():
                            best.inflight += 1
                            best.dispatched += 1
                            rep = best
                        else:
                            saw_breaker_block = True
                            skip.add(best.rid)
                            continue
                rem = None
                if rep is not None and freq.deadline is not None:
                    rem = freq.deadline.remaining()
                    if rem < 0.001:
                        rem = 0.001
            if expired:
                self._resolve(freq, None, DeadlineExceeded(
                    "request deadline expired before dispatch"))
                return True, "dispatched"
            if rep is None:
                if saw_rejection:
                    return False, "rejected"
                if saw_breaker_block:
                    return False, "breaker"
                return False, "noreplica"
            # outside _cond from here: per-replica admission + dispatch
            try:
                rep.admission.acquire()
            except ServerOverloaded as e:
                with self._cond:
                    rep.inflight -= 1
                    rep.rejected += 1
                    freq.last_error = e
                saw_rejection = True
                skip.add(rep.rid)
                continue
            t0 = time.monotonic()
            with self._cond:
                snap = freq.snapshot
            # degraded-mode dispatch onto the prefill tier: fresh
            # requests are pinned export_kv=False (serve co-located,
            # don't export snapshots nobody can adopt) and staged
            # snapshots adopt in place (adoption always decodes to
            # completion)
            colocated = (self._staged and rep.role == "prefill"
                         and (colocate or snap is not None))
            inner = None
            if snap is not None and hasattr(rep.server, "adopt_request"):
                # crash-durable failover: resume from the newest
                # harvested KV snapshot instead of regenerating from
                # token 0 — bit-exact either way, the snapshot only
                # saves the recompute
                try:
                    if freq.deadline is not None:
                        inner = rep.server.adopt_request(
                            snap, deadline_s=rem)
                    else:
                        inner = rep.server.adopt_request(snap)
                except SnapshotError:
                    # corrupted/unsupported snapshot is never fatal:
                    # drop it and fall through to a token-0 submit on
                    # this same replica
                    with self._cond:
                        if freq.snapshot is snap:
                            freq.snapshot = None
                    self._m_handoff_fallbacks.inc()
                except Exception as e:
                    # adoption refused (overloaded, breaker, closing):
                    # same handling as a submit rejection — try the
                    # next replica, snapshot kept for the next attempt
                    rep.admission.release()
                    with self._cond:
                        rep.inflight -= 1
                        rep.rejected += 1
                        rep.fail_ewma = ((1.0 - self._alpha)
                                         * rep.fail_ewma + self._alpha)
                        freq.last_error = e
                    rep.breaker.record_failure()
                    saw_rejection = True
                    skip.add(rep.rid)
                    continue
                else:
                    self._m_handoff_resumes.inc()
            if inner is None:
                try:
                    kwargs = freq.kwargs
                    if freq.deadline is not None or colocated:
                        kwargs = dict(kwargs)
                        if freq.deadline is not None:
                            kwargs["deadline_s"] = rem
                        if colocated:
                            kwargs["export_kv"] = False
                    inner = rep.server.submit(*freq.args, **kwargs)
                except ValueError:
                    rep.admission.release()
                    with self._cond:
                        rep.inflight -= 1
                    raise
                except Exception as e:
                    rep.admission.release()
                    with self._cond:
                        rep.inflight -= 1
                        rep.rejected += 1
                        rep.fail_ewma = ((1.0 - self._alpha)
                                         * rep.fail_ewma + self._alpha)
                        freq.last_error = e
                    rep.breaker.record_failure()
                    saw_rejection = True
                    skip.add(rep.rid)
                    continue
            with self._cond:
                freq.tried.add(rep.rid)
                freq.attempts += 1
                freq.active[rep.rid] = inner
                freq.t_dispatch = t0
                if hedge:
                    freq.hedges += 1
            if hedge:
                self._m_hedged.inc()
            if colocated:
                self._m_degraded_submits.inc()
            # if `inner` is already done this fires the callback inline
            inner.add_done_callback(
                functools.partial(self._replica_done, freq, rep, t0))
            return True, "dispatched"

    def _replica_done(self, freq: _FleetRequest, rep: _Replica, t0: float,
                      fut: Future) -> None:
        """Completion arbiter for one replica attempt. May run inline on
        the replica server's own threads *while that server holds its
        internal lock* — so this takes only ``_cond`` and never calls
        back into any replica server."""
        lat_ms = (time.monotonic() - t0) * 1000.0
        cancelled = fut.cancelled()
        exc = None if cancelled else fut.exception()
        died = isinstance(exc, ReplicaKilled)
        with self._cond:
            current = self._replicas[rep.rid] is rep
            rep.inflight -= 1
            if cancelled:
                pass
            elif exc is None:
                rep.completed += 1
                if rep.ewma_ms == 0.0:
                    rep.ewma_ms = lat_ms
                else:
                    rep.ewma_ms = ((1.0 - self._alpha) * rep.ewma_ms
                                   + self._alpha * lat_ms)
                rep.fail_ewma = (1.0 - self._alpha) * rep.fail_ewma
            else:
                rep.failed += 1
                rep.fail_ewma = ((1.0 - self._alpha) * rep.fail_ewma
                                 + self._alpha)
            counted_death = died and current and rep.state == READY
            if counted_death:
                rep.state = DEAD
                rep.restart_at = time.monotonic() + rep.backoff_s
            # harvest the attempt's KV snapshot off the failed future
            # (periodic snapshotting / drain-migrate attach it there);
            # newest stream position wins across attempts, so failover
            # resumes from the furthest crash-durable point
            if exc is not None and not cancelled:
                snap = getattr(fut, "_kv_snapshot", None)
                if snap is not None and (
                        freq.snapshot is None
                        or snap.count > freq.snapshot.count):
                    freq.snapshot = snap
            freq.active.pop(rep.rid, None)
            has_twin = len(freq.active) > 0
            is_resolved = freq.resolved
            stopping = self._stop
            self._cond.notify_all()
        if counted_death:
            self._m_deaths.inc()
        rep.admission.release()
        if cancelled:
            return
        if exc is None:
            rep.breaker.record_success()
            result = fut.result()
            if self._staged and isinstance(result, KVSnapshot):
                # stage 1 of the tier pipeline complete: the prefill
                # replica exported the request as a snapshot — stage it
                # for the decode tier instead of resolving the caller
                self._stage_handoff(freq, fut, result)
                return
            self._note_first_token(freq, fut)
            with self._cond:
                tfirst = freq.t_first
            if tfirst and hasattr(result, "__len__") and len(result) > 1:
                self.itl_hist.observe((time.monotonic() - tfirst)
                                      * 1000.0 / (len(result) - 1))
            self._resolve(freq, result, None)
            return
        rep.breaker.record_failure()
        if is_resolved:
            return
        if isinstance(exc, DeadlineExceeded):
            # the budget is global: a hedge twin cannot beat it either
            self._resolve(freq, None, exc)
            return
        if has_twin:
            return  # the hedge twin is still running and may win
        if stopping:
            self._resolve(freq, None, exc)
            return
        if freq.deadline is not None and freq.deadline.expired():
            self._resolve(freq, None, DeadlineExceeded(
                "request deadline expired during replica failover"))
            return
        if (self._max_redispatch is not None
                and freq.attempts > self._max_redispatch):
            self._resolve(freq, None, exc)
            return
        with self._cond:
            parked = not freq.resolved and not self._stop
            if parked:
                self._pending.append(freq)
                self._cond.notify_all()
        if parked:
            self._m_redispatched.inc()
            return
        self._resolve(freq, None, exc)

    def _note_first_token(self, freq: _FleetRequest, fut: Future) -> None:
        """Record TTFT once per request, the first time the fleet learns
        a token exists — off the replica's ``_t_first`` monotonic stamp
        (snapshot handoff or final completion). Futures without a stamp
        (adoption resumes, inference servers) never observe: their first
        token predates this attempt or doesn't exist."""
        tf = getattr(fut, "_t_first", None)
        if tf is None:
            return
        with self._cond:
            if freq.t_first:
                return
            freq.t_first = tf
            t_submit = freq.t_submit
        self.ttft_hist.observe((tf - t_submit) * 1000.0)

    def _stage_handoff(self, freq: _FleetRequest, fut: Future,
                       snap: KVSnapshot) -> None:
        """Stage 2 of the tier pipeline: a prefill attempt resolved to a
        KVSnapshot instead of tokens. Record TTFT (the first token is in
        the snapshot), stash the snapshot, and park the request for the
        monitor to route onto the decode tier — behind the same caller
        Future, which only ever resolves with final tokens. May run
        inline under the prefill server's lock: takes only ``_cond``."""
        self._note_first_token(freq, fut)
        with self._cond:
            parked = not freq.resolved and not self._stop
            if parked:
                if (freq.snapshot is None
                        or snap.count > freq.snapshot.count):
                    freq.snapshot = snap
                if freq not in self._pending:  # hedge twin staged first
                    self._pending.append(freq)
                self._cond.notify_all()
        if parked:
            self._m_tier_handoffs.inc()
            return
        if not freq.resolved:
            self._resolve(freq, None, RuntimeError(
                "ReplicaFleet stopped with the request mid-handoff"))

    def _resolve(self, freq: _FleetRequest, value: Any,
                 exc: Optional[BaseException], *,
                 rejected: bool = False) -> bool:
        """Resolve the caller-facing future exactly once (first caller
        wins) and cancel any still-running duplicate attempts. Submit-time
        rejections (``rejected=True``: typed shed re-raised to the caller,
        or ``exc is None and value is None`` for ValueError unlinks) count
        as ``rejected_submits`` rather than ``failed`` — the request was
        never accepted, so ``submitted == completed + failed + expired +
        rejected_submits`` once the fleet is idle."""
        with self._cond:
            if freq.resolved:
                return False
            freq.resolved = True
            self._inflight_reqs.discard(freq)
            losers = list(freq.active.values())
            self._cond.notify_all()
        if losers:
            self._m_losers_cancelled.inc(len(losers))
        if rejected or (exc is None and value is None):
            self._m_rejected_submits.inc()
        elif exc is None:
            self._m_completed.inc()
        elif isinstance(exc, DeadlineExceeded):
            self._m_expired.inc()
        else:
            self._m_failed.inc()
        for loser in losers:
            loser.cancel()  # queued attempts die; running ones are ignored
        try:
            if exc is None:
                if freq.t_first:
                    # TTFT stamp rides the caller future (same contract
                    # as the replica servers'), so a pipeline stacked on
                    # the fleet — RAG — can observe end-to-end TTFT
                    freq.future._t_first = freq.t_first
                freq.future.set_result(value)
            else:
                # the newest harvested snapshot rides the failed future
                # (same contract as GenerationServer's): whoever holds
                # it — the federation host publisher — can re-home the
                # request at its final crash-durable position
                snap = freq.snapshot
                if snap is not None:
                    cur = getattr(freq.future, "_kv_snapshot", None)
                    if cur is None or snap.count > cur.count:
                        freq.future._kv_snapshot = snap
                freq.future.set_exception(exc)
        except Exception:
            pass  # caller cancelled the fleet future: outcome dropped
        return True

    # -- monitor: redispatch, hedging, supervised restart --------------

    def _wake_monitor(self) -> None:
        """Runtime wake hook: nudge a tick blocked on ``_cond``."""
        with self._cond:
            self._cond.notify_all()

    def _monitor_tick(self) -> bool:
        """One monitor round, hosted by the ``ServingLoop`` tick thread
        ("fleet-monitor"). Returns False only on a clean stop."""
        with self._cond:
            if self._stop:
                return False
            self._cond.wait(timeout=self._tick_s)
            if self._stop:
                return False
            now = time.monotonic()
            work = []
            while self._pending:
                work.append(self._pending.popleft())
            spawn = []
            if self._restart:
                for r in self._replicas:
                    if r.state == DEAD and r.restart_at <= now:
                        r.state = SPAWNING
                        spawn.append(r.rid)
            if self._staged and self._degraded and any(
                    r.state == READY
                    and r.role in ("decode", "unified")
                    for r in self._replicas):
                # a decode-capable replica healed: leave degraded
                # mode; new work flows through the tier pipeline
                self._note_degraded(False)
            hedges = []
            if self._hedge_after_s is not None:
                for freq in self._inflight_reqs:
                    if (not freq.resolved
                            and len(freq.active) == 1
                            and freq.hedges < self._max_hedges
                            and now - freq.t_dispatch
                            >= self._hedge_after_s):
                        hedges.append(freq)
            # crash-durable publication: mirror each live attempt's
            # newest periodic snapshot (generation servers attach them
            # to the inner future as they decode) onto the fleet
            # request and the caller-facing future, so a host-level
            # wrapper (federation.FleetHost) can ship the newest stream
            # position off-process without reaching into replica
            # internals
            for freq in self._inflight_reqs:
                for inner in freq.active.values():
                    snap = getattr(inner, "_kv_snapshot", None)
                    if snap is not None and (
                            freq.snapshot is None
                            or snap.count > freq.snapshot.count):
                        freq.snapshot = snap
                if freq.snapshot is not None:
                    cur = getattr(freq.future, "_kv_snapshot", None)
                    if cur is None or freq.snapshot.count > cur.count:
                        freq.future._kv_snapshot = freq.snapshot
        for rid in spawn:
            self._respawn(rid)
        for freq in work:
            self._service_parked(freq)
        for freq in hedges:
            try:
                self._route_once(freq, hedge=True)
            except ValueError:
                pass  # original attempt is still running; let it win
        return True

    def _on_monitor_death(self, loop, exc) -> bool:
        """Supervisor recovery hook: the monitor thread died. Parked and
        in-flight requests are untouched when the monitor restarts (the
        replicas keep serving; redispatch resumes on the fresh thread) —
        but on a deliberately closing fleet the parked queue is failed
        typed so nothing hangs."""
        with self._cond:
            again = not self._user_close
            parked = [] if again else list(self._pending)
            if not again:
                self._pending.clear()
            self._cond.notify_all()
        err = LoopCrashed(f"fleet-monitor died with the request parked: "
                          f"{exc!r}")
        for freq in parked:
            self._resolve(freq, None, err)
        return again

    def _service_parked(self, freq: _FleetRequest) -> None:
        try:
            routed, _reason = self._route_once(freq)
        except ValueError as e:
            self._resolve(freq, None, e)
            return
        if routed:
            return
        with self._cond:
            if not freq.resolved and not self._stop:
                self._pending.append(freq)  # retry next tick
                return
        self._resolve(freq, None, RuntimeError(
            "ReplicaFleet stopped with the request still queued"))

    def _respawn(self, rid: int) -> None:
        """Supervised restart of a dead replica (monitor thread only):
        close the corpse, rebuild via the factory, warm it, and swap it in
        with a fresh breaker. Spawn failures back off exponentially."""
        with self._cond:
            rep = self._replicas[rid]
            old_server = rep.server
        try:
            old_server.close(timeout=0.0)
        except Exception:
            pass
        try:
            server = self._factory(rid)
            if self._warmup is not None:
                with self._cond:
                    rep.state = WARMING
                self._warmup(server)
        except Exception:
            with self._cond:
                rep.state = DEAD
                rep.spawn_failures += 1
                rep.backoff_s = min(rep.backoff_s * 2.0,
                                    self._restart_backoff_cap_s)
                rep.restart_at = time.monotonic() + rep.backoff_s
            return
        fresh = self._new_replica(rid, 0, server)
        with self._cond:
            old = self._replicas[rid]
            fresh.generation = old.generation + 1
            fresh.restarts = old.restarts + 1
            fresh.spawn_failures = old.spawn_failures
            fresh.prior_trips = old.prior_trips + old.breaker.open_count
            # traffic counters are cumulative per replica *slot*: a restart
            # replaces the server, not the slot's ops history
            fresh.dispatched = old.dispatched
            fresh.completed = old.completed
            fresh.failed = old.failed
            fresh.rejected = old.rejected
            self._replicas[rid] = fresh
            self._cond.notify_all()
        self._m_restarts.inc()
