"""Thread-safe metrics registry: counters, gauges, histograms (the port's
own copy of ``deeplearning4j_tpu/metrics/registry.py``, same names, same
semantics, same rendering).

Three metric kinds:

- :class:`Counter` — monotone float, batched ``inc(n)``.
- :class:`Gauge` — settable level, or a *callback* gauge whose value is
  read lazily at collect time (``fn=``) so hot paths never write it.
- :class:`Histogram` — fixed cumulative buckets (Prometheus
  ``_bucket{le=...}`` semantics) plus a seeded reservoir (algorithm R)
  for p50/p90/p99/p999 nearest-rank quantiles, and a monotonic-clock
  ``timer()`` context manager.

Every metric guards its state with its own leaf lock, so instrumented
code never holds a serving lock (``_cond``) to publish, and ``stats()``
assembles its snapshot outside the serving locks. Registry writes happen
only at host boundaries (retire paths, loop edges), never inside a
device dispatch.

Metric names follow Prometheus conventions (``*_total`` counters,
unit-suffixed histograms). Families support label sets::

    reg = MetricsRegistry()
    c = reg.counter("requests_total", "served requests", labels=("code",))
    c.labels(code="200").inc()
    h = reg.histogram("latency_ms", "e2e latency")
    with h.timer():
        serve()
    h.quantile(0.99)

``NullRegistry`` is the same API with every operation a no-op.
"""

from __future__ import annotations

import bisect
import math
import random
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "DEFAULT_BUCKETS", "DEFAULT_QUANTILES", "global_registry",
]

# latency-in-ms oriented default buckets; +Inf is implicit
DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 500.0, 1000.0, 2500.0, 5000.0)
DEFAULT_QUANTILES = (0.5, 0.9, 0.99, 0.999)
DEFAULT_RESERVOIR = 1024


def nearest_rank(sorted_xs, q):
    """Nearest-rank quantile on a sorted sequence: the canonical
    ``max(0, ceil(q*n) - 1)`` index (``int(len(xs) * q)`` overshoots by
    one at small N)."""
    n = len(sorted_xs)
    if n == 0:
        return float("nan")
    idx = max(0, math.ceil(q * n) - 1)
    return sorted_xs[min(idx, n - 1)]


class _Timer:
    """Context manager observing elapsed milliseconds on a histogram.
    Monotonic clock: timers measure durations, never wall-clock."""

    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._hist.observe((time.monotonic() - self._t0) * 1000.0)
        return False


class Counter:
    """Monotone counter. ``inc(n)`` supports batched adds (generation's
    per-dispatch counter updates land as one locked add)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError("counter can only increase")
        with self._lock:
            self._v += n

    @property
    def value(self):
        with self._lock:
            return self._v


class Gauge:
    """Settable level, or a callback gauge (``fn=``) evaluated at
    collect time — admission pending, breaker state, page-pool
    occupancy surface without any hot-path write."""

    __slots__ = ("_lock", "_v", "_fn")

    def __init__(self, fn=None):
        self._lock = threading.Lock()
        self._v = 0.0
        self._fn = fn

    def set(self, v):
        with self._lock:
            self._v = v

    def inc(self, n=1.0):
        with self._lock:
            self._v += n

    def dec(self, n=1.0):
        with self._lock:
            self._v -= n

    @property
    def value(self):
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._v


class Histogram:
    """Fixed cumulative buckets + seeded reservoir quantiles.

    Buckets carry Prometheus semantics: ``_bucket{le=b}`` is the count
    of observations ``<= b`` (cumulative at snapshot time), ``+Inf``
    implicit. The reservoir is algorithm R over a per-histogram
    ``random.Random(seed)`` — string-seeded, so quantiles are
    deterministic across runs regardless of ``PYTHONHASHSEED``. With
    ``reservoir >= n`` observations the quantiles are exact
    nearest-rank; beyond that they degrade gracefully to a uniform
    sample."""

    __slots__ = ("_lock", "_uppers", "_counts", "_sum", "_n",
                 "_res", "_res_cap", "_rng")

    def __init__(self, buckets=DEFAULT_BUCKETS, reservoir=DEFAULT_RESERVOIR,
                 seed="histogram"):
        self._lock = threading.Lock()
        self._uppers = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._uppers) + 1)  # last = +Inf
        self._sum = 0.0
        self._n = 0
        self._res = []
        self._res_cap = int(reservoir)
        self._rng = random.Random(seed)

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._n += 1
            self._sum += v
            self._counts[bisect.bisect_left(self._uppers, v)] += 1
            if len(self._res) < self._res_cap:
                self._res.append(v)
            else:
                j = self._rng.randrange(self._n)
                if j < self._res_cap:
                    self._res[j] = v

    def timer(self):
        return _Timer(self)

    @property
    def count(self):
        with self._lock:
            return self._n

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def quantile(self, q):
        with self._lock:
            xs = sorted(self._res)
        return nearest_rank(xs, q)

    def quantiles(self, qs=DEFAULT_QUANTILES):
        with self._lock:
            xs = sorted(self._res)
        return {q: nearest_rank(xs, q) for q in qs}

    def _snapshot(self):
        with self._lock:
            counts = list(self._counts)
            total = self._n
            s = self._sum
            xs = sorted(self._res)
        cum = 0
        buckets = []
        for upper, c in zip(self._uppers, counts):
            cum += c
            buckets.append((upper, cum))
        buckets.append((math.inf, total))
        return {
            "buckets": buckets, "sum": s, "count": total,
            "quantiles": {q: nearest_rank(xs, q) for q in DEFAULT_QUANTILES},
        }


class _Family:
    """One named metric family; children keyed by label values. With no
    label names the family has a single anonymous child and proxies the
    metric API (``inc``/``set``/``observe``/...) straight to it."""

    kind = "untyped"

    def __init__(self, name, help_text, label_names, maker):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._maker = maker
        self._lock = threading.Lock()
        self._children = {}

    def labels(self, **kv):
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._maker()
                self._children[key] = child
            return child

    def samples(self):
        """[(labels_dict, metric)] — labels_dict ordered as declared."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.label_names, key)), m) for key, m in items]

    def _default(self):
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} has labels {self.label_names}; "
                "use .labels(...)")
        return self.labels()


class CounterFamily(_Family):
    kind = "counter"

    def inc(self, n=1.0):
        self._default().inc(n)

    @property
    def value(self):
        return self._default().value


class GaugeFamily(_Family):
    kind = "gauge"

    def set(self, v):
        self._default().set(v)

    def inc(self, n=1.0):
        self._default().inc(n)

    def dec(self, n=1.0):
        self._default().dec(n)

    @property
    def value(self):
        return self._default().value


class HistogramFamily(_Family):
    kind = "histogram"

    def observe(self, v):
        self._default().observe(v)

    def timer(self):
        return self._default().timer()

    def quantile(self, q):
        return self._default().quantile(q)

    def quantiles(self, qs=DEFAULT_QUANTILES):
        return self._default().quantiles(qs)

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum


class MetricsRegistry:
    """Get-or-create metric families by name; snapshots for exposition.

    ``counter``/``gauge``/``histogram`` are idempotent: the same name
    returns the same family (a kind clash raises). Collection never
    blocks publication for long: ``_snapshot_families`` lists the
    families under the registry lock, then drains each family's leaf
    lock one at a time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}

    # ---- registration --------------------------------------------------

    def counter(self, name, help_text="", labels=()):
        return self._family(name, help_text, labels,
                            CounterFamily, Counter)

    def gauge(self, name, help_text="", labels=(), fn=None):
        return self._family(name, help_text, labels,
                            GaugeFamily, lambda: Gauge(fn=fn))

    def histogram(self, name, help_text="", labels=(),
                  buckets=DEFAULT_BUCKETS, reservoir=DEFAULT_RESERVOIR):
        return self._family(
            name, help_text, labels, HistogramFamily,
            lambda: Histogram(buckets=buckets, reservoir=reservoir,
                              seed=name))

    def _family(self, name, help_text, labels, fam_cls, maker):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = fam_cls(name, help_text, labels, maker)
                self._families[name] = fam
        if not isinstance(fam, fam_cls):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}")
        if tuple(labels) != fam.label_names:
            raise ValueError(
                f"metric {name!r} label set {fam.label_names} != "
                f"{tuple(labels)}")
        if not fam.label_names:
            fam.labels()  # eager default child: exposes 0 before first use
        return fam

    # ---- collection ----------------------------------------------------

    def _snapshot_families(self):
        """Collect every family into plain host data: no device fetches,
        no float()/int() coercions — values are already host floats when
        they get here."""
        with self._lock:
            fams = list(self._families.values())
        out = []
        for fam in fams:
            samples = []
            for lbls, metric in fam.samples():
                if fam.kind == "histogram":
                    samples.append((lbls, metric._snapshot()))
                else:
                    samples.append((lbls, metric.value))
            out.append({"name": fam.name, "help": fam.help,
                        "kind": fam.kind, "samples": samples})
        return out

    def snapshot(self):
        """JSON-friendly snapshot: {name: value | {labels...} | hist}."""
        out = {}
        for fam in self._snapshot_families():
            if fam["kind"] == "histogram":
                val = {("|".join(f"{k}={v}" for k, v in lbls.items())
                        if lbls else ""): data
                       for lbls, data in fam["samples"]}
                out[fam["name"]] = val.get("", val)
            elif any(lbls for lbls, _ in fam["samples"]):
                out[fam["name"]] = {
                    "|".join(f"{k}={v}" for k, v in lbls.items()): v2
                    for lbls, v2 in fam["samples"]}
            else:
                out[fam["name"]] = (fam["samples"][0][1]
                                    if fam["samples"] else 0.0)
        return out


class _NullMetric:
    """Accepts the whole metric API and does nothing."""

    def inc(self, n=1.0):
        pass

    def dec(self, n=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def timer(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def labels(self, **kv):
        return self

    def quantile(self, q):
        return float("nan")

    def quantiles(self, qs=DEFAULT_QUANTILES):
        return {q: float("nan") for q in qs}

    @property
    def value(self):
        return 0.0

    @property
    def count(self):
        return 0

    @property
    def sum(self):
        return 0.0


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Same API as :class:`MetricsRegistry`, every operation a no-op —
    the control leg of the metrics-overhead gate."""

    def counter(self, name, help_text="", labels=()):
        return _NULL_METRIC

    def gauge(self, name, help_text="", labels=(), fn=None):
        return _NULL_METRIC

    def histogram(self, name, help_text="", labels=(),
                  buckets=DEFAULT_BUCKETS, reservoir=DEFAULT_RESERVOIR):
        return _NULL_METRIC

    def _snapshot_families(self):
        return []

    def snapshot(self):
        return {}


_GLOBAL = MetricsRegistry()


def global_registry():
    """The process-wide default registry. Training-side surfaces (the
    health guard, StatsListener) publish here so a serving process and
    its training loop share one scrape."""
    return _GLOBAL
