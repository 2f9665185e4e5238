"""REST k-NN service and the retrieval stores (the port of
``deeplearning4j_tpu/nearestneighbors``; reference:
deeplearning4j-nearestneighbor-server).

``DeviceBruteForceIndex`` and ``EmbeddingIndex`` are re-exported lazily, as
the JAX package re-exports them.
"""

from deeplearning4j_torch.nearestneighbors.server import NearestNeighborsServer

__all__ = ["DeviceBruteForceIndex", "EmbeddingIndex",
           "NearestNeighborsServer"]


def __getattr__(name):
    if name == "DeviceBruteForceIndex":
        from deeplearning4j_torch.nearestneighbors.brute import (
            DeviceBruteForceIndex,
        )

        return DeviceBruteForceIndex
    if name == "EmbeddingIndex":
        from deeplearning4j_torch.nearestneighbors.index import EmbeddingIndex

        return EmbeddingIndex
    raise AttributeError(name)
