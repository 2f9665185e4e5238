"""In-memory graph, host code (the port's own copy of
``deeplearning4j_tpu/graph/graph.py``; reference: deeplearning4j-graph
graph/api/IGraph.java + graph/graph/Graph.java — adjacency-list graph with
optional edge weights)."""

from __future__ import annotations


class Graph:
    def __init__(self, num_vertices: int, directed: bool = False):
        self.num_vertices_ = num_vertices
        self.directed = directed
        self._adj: list = [[] for _ in range(num_vertices)]  # (to, weight)

    @staticmethod
    def from_edges(num_vertices: int, edges, directed: bool = False
                   ) -> "Graph":
        g = Graph(num_vertices, directed)
        for e in edges:
            if len(e) == 2:
                g.add_edge(e[0], e[1])
            else:
                g.add_edge(e[0], e[1], e[2])
        return g

    def add_edge(self, a: int, b: int, weight: float = 1.0) -> None:
        self._adj[a].append((b, weight))
        if not self.directed:
            self._adj[b].append((a, weight))

    def num_vertices(self) -> int:
        return self.num_vertices_

    def neighbors(self, v: int) -> list:
        return [t for t, _ in self._adj[v]]

    def edges_out(self, v: int) -> list:
        return list(self._adj[v])

    def degree(self, v: int) -> int:
        return len(self._adj[v])
