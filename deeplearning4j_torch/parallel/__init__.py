"""Parallelism on the devices of one process (port of the
``deeplearning4j_tpu.parallel`` package): data-parallel training
(``ParallelWrapper``), data-parallel inference and evaluation,
tensor-parallel serving, replica fleets, and the resilience layer. The
mesh-spanning parts that need several processes or hosts (process groups,
federation, parameter servers, pipeline and model sharding) are ROADMAP
A11c and are not exported.

The names resolve on first use (PEP 562): modules outside this package
import ``parallel.runtime`` and ``parallel.resilience``, which the
exported modules import in turn, so eager imports here would be a cycle.
"""

import importlib

_EXPORTS = {
    "ParallelWrapper": "trainer",
    "data_model_mesh": "mesh",
    "data_mesh": "mesh",
    "ParallelInference": "inference",
    "GenerationServer": "generation",
    "ReplicaFleet": "fleet",
    "evaluate_on_mesh": "evaluation",
    "EarlyStoppingParallelTrainer": "early_stopping",
    "CheckpointListener": "elastic",
    "CheckpointStore": "elastic",
    **{name: "resilience" for name in (
        "AdmissionController", "ChaosPolicy", "CircuitBreaker",
        "CircuitOpen", "Deadline", "DeadlineExceeded", "ReplicaKilled",
        "ReplicaUnavailable", "ResilienceError", "RetryPolicy",
        "ServerOverloaded", "StreamStalled", "TransientDispatchError")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
