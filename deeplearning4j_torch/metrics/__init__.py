"""Observability for the port's serving surfaces: the metrics registry, its
Prometheus text exposition, the queue-driven autoscaler and the seeded load
generator (the port's own copies of ``deeplearning4j_tpu/metrics/``).

Every serving surface (``GenerationServer``, ``ParallelInference``,
``ReplicaFleet``, ``KerasBackendServer``) publishes its counters through
one :class:`MetricsRegistry` (its ``registry=`` argument, or a registry of
its own); ``render_text`` renders registries as the ``GET /metrics`` page
and ``stats()`` is re-derived from the same counters.
"""

from deeplearning4j_torch.metrics.registry import (  # noqa: F401
    DEFAULT_BUCKETS, DEFAULT_QUANTILES, Counter, Gauge, Histogram,
    MetricsRegistry, NullRegistry, global_registry, nearest_rank)
from deeplearning4j_torch.metrics.exposition import (  # noqa: F401
    CONTENT_TYPE, render_text)
from deeplearning4j_torch.metrics.autoscale import (  # noqa: F401
    Autoscaler, CoalescerTarget, GenerationSlotsTarget, ScaleDecision)
from deeplearning4j_torch.metrics.loadgen import (  # noqa: F401
    LoadGenerator, LoadResult, poisson_arrivals, ramp_profile,
    spike_profile)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "DEFAULT_BUCKETS", "DEFAULT_QUANTILES", "global_registry",
    "nearest_rank", "render_text", "CONTENT_TYPE", "Autoscaler",
    "ScaleDecision", "GenerationSlotsTarget", "CoalescerTarget",
    "LoadGenerator", "LoadResult", "ramp_profile", "spike_profile",
    "poisson_arrivals",
]
