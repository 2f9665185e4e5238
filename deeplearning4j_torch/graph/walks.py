"""Random-walk generators, host numpy (the port's own copy of
``deeplearning4j_tpu/graph/walks.py``: the same walks for a seed;
reference: deeplearning4j-graph
graph/iterator/RandomWalkIterator.java, WeightedRandomWalkGraphIteratorProvider,
and node2vec's p/q-biased second-order walks)."""

from __future__ import annotations

import numpy as np


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex (reference:
    RandomWalkIterator.java; NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)."""

    def __init__(self, graph, walk_length: int, walks_per_vertex: int = 1,
                 seed: int = 0):
        self.graph = graph
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                cur = start
                for _ in range(self.walk_length - 1):
                    nbrs = self.graph.neighbors(cur)
                    cur = int(rng.choice(nbrs)) if nbrs else cur
                    walk.append(cur)
                yield walk

    def reset(self):
        pass


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional transitions (reference: weighted walk
    provider)."""

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                cur = start
                for _ in range(self.walk_length - 1):
                    edges = self.graph.edges_out(cur)
                    if edges:
                        w = np.asarray([e[1] for e in edges], np.float64)
                        cur = edges[rng.choice(len(edges),
                                               p=w / w.sum())][0]
                    walk.append(cur)
                yield walk


class Node2VecWalkIterator(RandomWalkIterator):
    """Second-order p/q-biased walks (node2vec, Grover & Leskovec 2016 —
    return parameter p, in-out parameter q)."""

    def __init__(self, graph, walk_length: int, walks_per_vertex: int = 1,
                 p: float = 1.0, q: float = 1.0, seed: int = 0):
        super().__init__(graph, walk_length, walks_per_vertex, seed)
        self.p = p
        self.q = q

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                prev = None
                cur = start
                for _ in range(self.walk_length - 1):
                    nbrs = self.graph.neighbors(cur)
                    if not nbrs:
                        walk.append(cur)
                        continue
                    if prev is None:
                        nxt = int(rng.choice(nbrs))
                    else:
                        prev_nbrs = set(self.graph.neighbors(prev))
                        w = np.asarray(
                            [1.0 / self.p if n == prev
                             else (1.0 if n in prev_nbrs else 1.0 / self.q)
                             for n in nbrs], np.float64)
                        nxt = nbrs[rng.choice(len(nbrs), p=w / w.sum())]
                    walk.append(nxt)
                    prev, cur = cur, nxt
                yield walk
