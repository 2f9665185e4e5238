"""Queue-driven autoscaler for the serving layer (the port's own copy of
``deeplearning4j_tpu/metrics/autoscale.py``).

Grows and shrinks two capacity levers from observed queue depth and
deadline-miss rate:

- GenerationServer **active decode slots** — the slot pool is allocated
  once with the device KV pools, so scaling changes an *admission cap*
  (``set_active_slots``), never the pool itself; shrinking takes effect
  as slots retire.
- ParallelInference **coalescer workers** — extra coalescer threads on
  the shared submit queue (``set_coalescer_workers``).

Discipline: hysteresis (a breach must persist ``up_ticks`` /
``down_ticks`` consecutive observations) plus a per-target cooldown
after any change, so an oscillating load produces *zero* decisions
instead of flapping. The clock is injectable and ``tick()`` is manual,
so tests drive the whole state machine deterministically; ``start()``
runs the same tick on a background thread for production.

Every decision lands in the registry
(``autoscale_decisions_total{target,action}``,
``autoscale_level{target}``) and in ``decisions`` as a typed record.
"""

from __future__ import annotations

import collections
import threading
import time

from deeplearning4j_torch.metrics.registry import MetricsRegistry

__all__ = ["Autoscaler", "ScaleDecision", "GenerationSlotsTarget",
           "CoalescerTarget", "FleetTierTarget"]


class ScaleDecision:
    """One autoscaling action (or refusal), fully typed."""

    __slots__ = ("t", "target", "action", "level_from", "level_to",
                 "queue_depth", "miss_rate", "reason")

    def __init__(self, t, target, action, level_from, level_to,
                 queue_depth, miss_rate, reason):
        self.t = t
        self.target = target
        self.action = action            # "scale_up" | "scale_down"
        self.level_from = level_from
        self.level_to = level_to
        self.queue_depth = queue_depth
        self.miss_rate = miss_rate
        self.reason = reason

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return (f"ScaleDecision({self.target}: {self.action} "
                f"{self.level_from}->{self.level_to} depth="
                f"{self.queue_depth} miss={self.miss_rate:.3f})")


class _StatsTarget:
    """Adapter base: derives (queue depth, deadline-miss rate) from a
    server's public ``stats()`` dict via counter deltas between ticks."""

    name = "target"
    depth_key = "pending"

    def __init__(self, server):
        self._srv = server
        self._prev_misses = 0
        self._prev_served = 0

    def observe(self):
        st = self._srv.stats()
        misses = st["expired"]
        served = st["completed"]
        dm = max(0, misses - self._prev_misses)
        ds = max(0, served - self._prev_served)
        self._prev_misses = misses
        self._prev_served = served
        total = dm + ds
        rate = dm / total if total > 0 else 0.0
        return st[self.depth_key], rate


class GenerationSlotsTarget(_StatsTarget):
    """Scales GenerationServer's active-slot admission cap in
    [1, slots]."""

    name = "generation_slots"
    depth_key = "queued"

    @property
    def min_level(self):
        return 1

    @property
    def max_level(self):
        return self._srv.slots

    def get(self):
        return self._srv.active_slot_cap

    def set(self, n):
        self._srv.set_active_slots(n)


class CoalescerTarget(_StatsTarget):
    """Scales ParallelInference's coalescer worker count in
    [1, max_coalescers]."""

    name = "inference_coalescers"
    depth_key = "pending"

    @property
    def min_level(self):
        return 1

    @property
    def max_level(self):
        return self._srv.max_coalescers

    def get(self):
        return self._srv.coalescer_workers

    def set(self, n):
        self._srv.set_coalescer_workers(n)


class FleetTierTarget:
    """Per-tier slot lever over a disaggregated ReplicaFleet: one
    independent Autoscaler target per ``role`` (prefill capacity bounds
    TTFT, decode capacity bounds inter-token latency — they must scale
    separately). Observes aggregate queue depth and deadline-miss rate
    from ``fleet.tier_stats(role)`` counter deltas and moves the tier's
    shared active-slot admission cap via
    ``fleet.set_tier_active_slots(role, n)``."""

    depth_key = "queued"

    def __init__(self, fleet, role, max_slots=None):
        if role not in ("prefill", "decode", "unified", "knn", "generate"):
            raise ValueError(f"unknown tier role {role!r}")
        self._fleet = fleet
        self._role = role
        self.name = f"fleet_{role}_slots"
        self._max_slots = max_slots
        self._prev_misses = 0
        self._prev_served = 0
        self._level = None  # tracked cap survives tier-dark windows

    @property
    def min_level(self):
        return 1

    @property
    def max_level(self):
        if self._max_slots is not None:
            return self._max_slots
        st = self._fleet.tier_stats(self._role)
        reps = st["replicas"]
        if reps == 0:
            return self._level if self._level is not None else 1
        # the cap is per replica server, so the lever's ceiling is the
        # largest per-replica slot pool in the tier
        return max(1, st["slots"] // reps)

    def observe(self):
        st = self._fleet.tier_stats(self._role)
        misses = st["expired"]
        served = st["completed"]
        dm = max(0, misses - self._prev_misses)
        ds = max(0, served - self._prev_served)
        self._prev_misses = misses
        self._prev_served = served
        total = dm + ds
        rate = dm / total if total > 0 else 0.0
        return st[self.depth_key], rate

    def get(self):
        st = self._fleet.tier_stats(self._role)
        if st["replicas"] == 0:  # tier dark: hold the last known level
            return self._level if self._level is not None else 1
        level = max(1, st["active_slots"] // st["replicas"])
        self._level = level
        return level

    def set(self, n):
        self._level = n
        self._fleet.set_tier_active_slots(self._role, n)


class Autoscaler:
    """Hysteresis + cooldown controller over one or more targets.

    Scale up when queue depth > ``high_depth`` or miss rate >
    ``high_miss_rate`` for ``up_ticks`` consecutive ticks; scale down
    when depth < ``low_depth`` and miss rate ~ 0 for ``down_ticks``
    consecutive ticks. ``cooldown_s`` quarantines a target after any
    change. One step per decision."""

    def __init__(self, targets, *, high_depth=8, low_depth=1,
                 high_miss_rate=0.05, up_ticks=2, down_ticks=5,
                 cooldown_s=5.0, registry=None, clock=time.monotonic):
        self.targets = list(targets)
        self.high_depth = high_depth
        self.low_depth = low_depth
        self.high_miss_rate = high_miss_rate
        self.up_ticks = up_ticks
        self.down_ticks = down_ticks
        self.cooldown_s = cooldown_s
        self.decisions = collections.deque(maxlen=256)
        self._clock = clock
        self._state = {t.name: {"hi": 0, "lo": 0, "last_change": None}
                       for t in self.targets}
        self._thread = None
        self._stop = threading.Event()
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._m_decisions = self.metrics.counter(
            "autoscale_decisions_total", "autoscaler actions taken",
            labels=("target", "action"))
        self._m_ticks = self.metrics.counter(
            "autoscale_ticks_total", "autoscaler evaluation passes")
        self._m_level = self.metrics.gauge(
            "autoscale_level", "current capacity level", labels=("target",))
        self._m_depth = self.metrics.gauge(
            "autoscale_queue_depth", "last observed queue depth",
            labels=("target",))
        self._m_miss = self.metrics.gauge(
            "autoscale_miss_rate", "last observed deadline-miss rate",
            labels=("target",))

    # ---- the control loop ----------------------------------------------

    def tick(self):
        """Evaluate every target once; returns the decisions made."""
        return self._autoscale_tick()

    def _autoscale_tick(self):
        # observations are already host scalars: no device fetch here
        now = self._clock()
        self._m_ticks.inc()
        made = []
        for target in self.targets:
            depth, miss = target.observe()
            st = self._state[target.name]
            self._m_depth.labels(target=target.name).set(depth)
            self._m_miss.labels(target=target.name).set(miss)
            hot = depth > self.high_depth or miss > self.high_miss_rate
            cold = depth < self.low_depth and miss <= 0.0
            st["hi"] = st["hi"] + 1 if hot else 0
            st["lo"] = st["lo"] + 1 if cold else 0
            level = target.get()
            self._m_level.labels(target=target.name).set(level)
            last = st["last_change"]
            if last is not None and now - last < self.cooldown_s:
                continue
            if st["hi"] >= self.up_ticks and level < target.max_level:
                self._apply(target, st, now, level, level + 1, "scale_up",
                            depth, miss,
                            f"depth={depth} miss={miss:.3f} for "
                            f"{st['hi']} ticks")
                made.append(self.decisions[-1])
            elif st["lo"] >= self.down_ticks and level > target.min_level:
                self._apply(target, st, now, level, level - 1, "scale_down",
                            depth, miss,
                            f"idle for {st['lo']} ticks")
                made.append(self.decisions[-1])
        return made

    def _apply(self, target, st, now, level, new_level, action, depth,
               miss, reason):
        target.set(new_level)
        st["last_change"] = now
        st["hi"] = 0
        st["lo"] = 0
        self._m_decisions.labels(target=target.name, action=action).inc()
        self._m_level.labels(target=target.name).set(new_level)
        self.decisions.append(ScaleDecision(
            t=now, target=target.name, action=action, level_from=level,
            level_to=new_level, queue_depth=depth, miss_rate=miss,
            reason=reason))

    # ---- background operation ------------------------------------------

    def start(self, interval_s=1.0):
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(interval_s):
                self.tick()

        self._thread = threading.Thread(target=_run, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    def stats(self):
        return {
            "targets": {t.name: t.get() for t in self.targets},
            "decisions": [d.as_dict() for d in self.decisions],
        }
