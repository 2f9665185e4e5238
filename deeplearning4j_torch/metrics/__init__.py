"""Observability for the port's serving surfaces: the metrics registry and
its Prometheus text exposition (the port's own copies of
``deeplearning4j_tpu/metrics/registry.py`` and ``exposition.py``).

Every ``GenerationServer`` publishes its counters through one
:class:`MetricsRegistry` (its ``registry=`` argument, or a registry of its
own); ``render_text`` renders registries as the ``GET /metrics`` page and
``stats()`` is re-derived from the same counters. The autoscaler and the
load generator of the JAX package's ``metrics/`` are not ported yet
(ROADMAP A8).
"""

from deeplearning4j_torch.metrics.exposition import (  # noqa: F401
    CONTENT_TYPE, render_text)
from deeplearning4j_torch.metrics.registry import (  # noqa: F401
    DEFAULT_BUCKETS, DEFAULT_QUANTILES, Counter, Gauge, Histogram,
    MetricsRegistry, NullRegistry, global_registry, nearest_rank)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "DEFAULT_BUCKETS", "DEFAULT_QUANTILES", "global_registry",
    "nearest_rank", "render_text", "CONTENT_TYPE",
]
