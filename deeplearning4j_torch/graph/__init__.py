"""Graph embeddings (the port of ``deeplearning4j_tpu/graph``; reference:
deeplearning4j-graph — IGraph API, random-walk iterators, DeepWalk +
GraphHuffman)."""

from deeplearning4j_torch.graph.graph import Graph
from deeplearning4j_torch.graph.walks import (
    Node2VecWalkIterator,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)
from deeplearning4j_torch.graph.deepwalk import DeepWalk, Node2Vec

__all__ = ["Graph", "RandomWalkIterator", "WeightedRandomWalkIterator",
           "Node2VecWalkIterator", "DeepWalk", "Node2Vec"]
