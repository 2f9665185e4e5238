"""Batch placement over a data mesh (port of the data half of
``deeplearning4j_tpu/parallel/model_sharding.py``).

``data_batch_sharding`` is here; GSPMD model sharding (``ShardedTrainer``,
``shard_network``, ``network_param_specs``) is ROADMAP A11c.
"""

from __future__ import annotations

from deeplearning4j_torch.parallel.mesh import DataSharding, Mesh


def data_batch_sharding(mesh: Mesh, arr=None) -> DataSharding:
    """Batch (axis 0) split over ``data``, the rest whole. ``arr`` is
    accepted for JAX's signature; the placement does not depend on its
    rank."""
    return DataSharding(mesh)
