"""Seeded closed-loop load harness for the serving layer (the port's own
copy of ``deeplearning4j_tpu/metrics/loadgen.py``).

Two arrival processes:

- **open** — a non-homogeneous Poisson process: arrival times are
  precomputed by Lewis-Shedler thinning from a seeded RNG and a rate
  profile, then replayed against the wall clock. Latency is measured
  from the *scheduled* arrival, not the actual submit, so a stalled
  server inflates the tail instead of silently pacing the generator
  down (no coordinated omission).
- **closed** — N workers in submit-wait loops with optional think
  time; concurrency is the knob, rate is emergent.

Profiles are plain ``rate(t)`` callables; ``ramp_profile`` and
``spike_profile`` build a ramp and a burst. Everything is deterministic
under a fixed seed: the same schedule, the same request indices, the same
reservoir sampling.

The generator publishes into its own registry (``soak_latency_ms``
histogram, submitted/completed/failed counters) and returns a
:class:`LoadResult` with the SLO inputs: quantiles, achieved
throughput, error taxonomy, and the zero-lost-futures check
(``submitted == completed + failed``).
"""

from __future__ import annotations

import random
import threading
import time

from deeplearning4j_torch.metrics.registry import MetricsRegistry

__all__ = ["LoadGenerator", "LoadResult", "ramp_profile", "spike_profile",
           "poisson_arrivals"]


def ramp_profile(lo, hi, ramp_s):
    """Rate climbs linearly from ``lo`` to ``hi`` over ``ramp_s``,
    then holds at ``hi``."""
    span = max(ramp_s, 1e-9)

    def rate(t):
        frac = min(1.0, max(0.0, t / span))
        return lo + (hi - lo) * frac

    return rate


def spike_profile(base, spike, at_s, dur_s):
    """Constant ``base`` with a rectangular burst to ``spike`` during
    ``[at_s, at_s + dur_s)``."""

    def rate(t):
        return spike if at_s <= t < at_s + dur_s else base

    return rate


def poisson_arrivals(rate_fn, duration_s, rate_max, seed):
    """Arrival offsets in [0, duration_s) by Lewis-Shedler thinning of
    a homogeneous Poisson process at ``rate_max``. Deterministic for a
    fixed seed."""
    rng = random.Random(seed)
    t = 0.0
    out = []
    while True:
        t += rng.expovariate(rate_max)
        if t >= duration_s:
            return out
        if rng.random() * rate_max <= rate_fn(t):
            out.append(t)


class LoadResult:
    """Outcome of one load run; everything the SLO gate needs."""

    def __init__(self, hist, submitted, completed, failed, errors,
                 duration_s):
        self.hist = hist
        self.submitted = submitted
        self.completed = completed
        self.failed = failed
        self.errors = dict(errors)      # error type name -> count
        self.duration_s = duration_s

    @property
    def lost(self):
        """Futures that never resolved — must be zero."""
        return self.submitted - self.completed - self.failed

    @property
    def achieved_req_s(self):
        return self.completed / self.duration_s if self.duration_s else 0.0

    def quantile(self, q):
        return self.hist.quantile(q)

    def as_dict(self):
        return {
            "submitted": self.submitted, "completed": self.completed,
            "failed": self.failed, "lost": self.lost,
            "errors": self.errors, "duration_s": self.duration_s,
            "achieved_req_s": self.achieved_req_s,
            "p50_ms": self.hist.quantile(0.5),
            "p99_ms": self.hist.quantile(0.99),
        }


class LoadGenerator:
    """Drives ``submit_fn(i) -> future`` under a seeded arrival process.

    The future only needs ``add_done_callback``; latency is recorded in
    the callback against the scheduled (open) or issued (closed)
    arrival time on the monotonic clock."""

    def __init__(self, submit_fn, *, seed=0, registry=None,
                 reservoir=65536):
        self._submit = submit_fn
        self._seed = seed
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._hist = self.metrics.histogram(
            "soak_latency_ms", "request latency from scheduled arrival",
            reservoir=reservoir)
        self._m_submitted = self.metrics.counter(
            "soak_submitted_total", "requests issued")
        self._m_completed = self.metrics.counter(
            "soak_completed_total", "requests resolved ok")
        self._m_failed = self.metrics.counter(
            "soak_failed_total", "requests resolved with a typed error")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._submitted = 0
        self._resolved = 0
        self._failed = 0
        self._errors = {}

    # ---- completion plumbing -------------------------------------------

    def _record(self, fut, t_ref, t0, done_event=None):
        lat_ms = (time.monotonic() - t0 - t_ref) * 1000.0
        err = None
        try:
            err = fut.exception()
        except Exception as e:          # future-likes without exception()
            err = e
        if err is None:
            self._hist.observe(lat_ms)
            self._m_completed.inc()
        else:
            self._m_failed.inc()
        with self._lock:
            self._resolved += 1
            if err is not None:
                self._failed += 1
                name = type(err).__name__
                self._errors[name] = self._errors.get(name, 0) + 1
            self._cv.notify_all()
        if done_event is not None:
            done_event.set()

    def _issue(self, i, t_ref, t0, done_event=None):
        self._m_submitted.inc()
        with self._lock:
            self._submitted += 1
        try:
            fut = self._submit(i)
        except Exception as e:
            # synchronous rejection (admission/breaker) = resolved failure
            self._m_failed.inc()
            with self._lock:
                self._resolved += 1
                self._failed += 1
                name = type(e).__name__
                self._errors[name] = self._errors.get(name, 0) + 1
                self._cv.notify_all()
            if done_event is not None:
                done_event.set()
            return
        fut.add_done_callback(
            lambda f, r=t_ref, z=t0, d=done_event: self._record(f, r, z, d))

    # ---- open loop -----------------------------------------------------

    def run_open(self, rate_fn, duration_s, rate_max, timeout_s=None):
        """Replay a precomputed Poisson schedule; block until every
        issued request resolves."""
        sched = poisson_arrivals(rate_fn, duration_s, rate_max, self._seed)
        t0 = time.monotonic()
        self._soak_arrival_loop(sched, t0)
        elapsed = self._await_quiesce(t0, timeout_s)
        return self._result(elapsed)

    def _soak_arrival_loop(self, sched, t0):
        # pacing + submit only: no device fetch, no scalar coercion
        for i, ts in enumerate(sched):
            delay = ts - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            self._issue(i, ts, t0)

    # ---- closed loop ---------------------------------------------------

    def run_closed(self, workers, requests_per_worker, think_s=0.0,
                   timeout_s=None):
        """N workers in submit-wait loops; latency from each submit."""
        t0 = time.monotonic()

        def _worker(w):
            rng = random.Random(self._seed * 7919 + w)
            for k in range(requests_per_worker):
                t_ref = time.monotonic() - t0
                done = threading.Event()
                self._issue(w * requests_per_worker + k, t_ref, t0,
                            done_event=done)
                done.wait(timeout=60.0)  # closed loop: one in flight
                if think_s:
                    time.sleep(rng.uniform(0.0, 2.0 * think_s))

        threads = [threading.Thread(target=_worker, args=(w,),
                                    name=f"loadgen-{w}", daemon=True)
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = self._await_quiesce(t0, timeout_s)
        return self._result(elapsed)

    # ---- shared tail ---------------------------------------------------

    def _await_quiesce(self, t0, timeout_s):
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        with self._cv:
            while self._resolved < self._submitted:
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(min(left, 1.0))
                else:
                    self._cv.wait(1.0)
        return time.monotonic() - t0

    def _result(self, elapsed):
        with self._lock:
            submitted = self._submitted
            resolved = self._resolved
            failed = self._failed
            errors = dict(self._errors)
        completed = resolved - failed
        return LoadResult(self._hist, submitted, completed, failed,
                          errors, elapsed)
