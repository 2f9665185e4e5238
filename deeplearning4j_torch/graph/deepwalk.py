"""DeepWalk / Node2Vec (reference: deeplearning4j-graph
graph/models/deepwalk/DeepWalk.java + GraphHuffman.java — skip-gram with
hierarchical softmax over random walks).

The port of ``deeplearning4j_tpu/graph/deepwalk.py``: walks are drawn on
the host as the JAX package draws them, become token sequences, and the
port's SequenceVectors engine (vocab, Huffman, the device skipgram epochs)
trains them on ``device`` (CUDA unless the caller passes another) — the
reuse the reference gets from its GraphVectorsImpl/InMemoryGraphLookupTable
pair.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.graph.walks import (
    Node2VecWalkIterator,
    RandomWalkIterator,
)
from deeplearning4j_torch.nlp.sequence_vectors import SequenceVectors


class DeepWalk:
    """reference: DeepWalk.Builder (vectorSize, windowSize, learningRate) +
    fit(GraphWalkIterator)."""

    def __init__(self, vector_size: int = 100, window: int = 5,
                 learning_rate: float = 0.025, walk_length: int = 40,
                 walks_per_vertex: int = 10, epochs: int = 1,
                 negative: int = 0, use_hierarchic_softmax: bool = True,
                 seed: int = 12345, device=None):
        self.vector_size = vector_size
        self.window = window
        self.learning_rate = learning_rate
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.epochs = epochs
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.seed = seed
        self.device = device
        self._sv: SequenceVectors = None

    def _walks(self, graph):
        return RandomWalkIterator(graph, self.walk_length,
                                  self.walks_per_vertex, seed=self.seed)

    def fit(self, graph) -> "DeepWalk":
        resolve_device(self.device)       # the card, or the caller's device
        walks = [[str(v) for v in walk] for walk in self._walks(graph)]
        self._sv = SequenceVectors(
            layer_size=self.vector_size, window=self.window,
            min_word_frequency=1, epochs=self.epochs,
            learning_rate=self.learning_rate, negative=self.negative,
            use_hierarchic_softmax=self.use_hs, seed=self.seed,
            device=self.device)
        self._sv.fit(walks)
        return self

    def vertex_vector(self, v: int) -> np.ndarray:
        return self._sv.word_vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verts_nearest(self, v: int, top_n: int = 10) -> list:
        return [(int(w), s)
                for w, s in self._sv.words_nearest(str(v), top_n)]


class Node2Vec(DeepWalk):
    """p/q-biased DeepWalk (reference: models/node2vec/Node2Vec.java)."""

    def __init__(self, p: float = 1.0, q: float = 1.0, **kw):
        super().__init__(**kw)
        self.p = p
        self.q = q

    def _walks(self, graph):
        return Node2VecWalkIterator(graph, self.walk_length,
                                    self.walks_per_vertex, p=self.p,
                                    q=self.q, seed=self.seed)
