"""Parallelism on the devices of one process and across processes (port of the
``deeplearning4j_tpu.parallel`` package): data-parallel training
(``ParallelWrapper``), data-parallel inference and evaluation,
tensor-parallel serving, replica fleets, the resilience layer, and the
one-process model parallelism: dp x tp ``ShardedTrainer``, tensor-parallel
MLP blocks, ring and Ulysses attention, the GPipe ``PipelineTrainer``, the
Spark facade and the parameter server; and the processes of one host:
elastic training (``FaultTolerantTrainer``, heartbeats, fault injection)
and the fleet federation (``FleetHost`` processes behind a
``FleetFederation`` router); and process groups: ``distributed.py``'s
``initialize`` (a ``torch.distributed`` group, as the JAX module's
``jax.distributed``), after which the meshes span every rank's devices
and the data axis of ``ShardedTrainer``/``shard_network`` sums its
gradients over the ranks. As in the JAX package, ``distributed`` is a
module of its own, not exported here.

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
    "FailureDetector": "elastic",
    "FaultInjectionListener": "elastic",
    "FaultTolerantTrainer": "elastic",
    "Heartbeat": "elastic",
    "FleetFederation": "federation",
    "FleetHost": "federation",
    "HostHandle": "federation",
    "HostUnavailable": "federation",
    "spawn_host": "federation",
    "ShardedTrainer": "model_sharding",
    "PipelineTrainer": "pipeline",
    "ParameterServer": "parameter_server",
    "ParameterServerClient": "parameter_server",
    "ParameterServerParallelWrapper": "parameter_server",
    "ParameterAveragingTrainingMaster": "spark",
    "SparkDl4jMultiLayer": "spark",
    "SparkComputationGraph": "spark",
    "ring_attention": "sequence",
    "ulysses_attention": "sequence",
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
