"""KD-tree (the port's copy of ``deeplearning4j_tpu/clustering/kdtree.py``;
reference: deeplearning4j-core clustering/kdtree/KDTree.java — insert +
nn/knn/range queries). Host-side numpy: spatial search is pointer-chasing,
the workload that does not belong on the card; the device-side alternative
(brute-force matmul distances) lives in KMeansClustering and
VPTree.search_batch."""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np


class _Node:
    __slots__ = ("point", "index", "axis", "left", "right")

    def __init__(self, point, index, axis):
        self.point = point
        self.index = index
        self.axis = axis
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = dims
        self._root: Optional[_Node] = None
        self.size = 0

    @staticmethod
    def build(points) -> "KDTree":
        """Balanced build via median splits."""
        pts = np.asarray(points, np.float64)
        tree = KDTree(pts.shape[1])

        def rec(idx, depth):
            if idx.size == 0:
                return None
            axis = depth % tree.dims
            order = idx[np.argsort(pts[idx, axis])]
            mid = order.size // 2
            node = _Node(pts[order[mid]], int(order[mid]), axis)
            node.left = rec(order[:mid], depth + 1)
            node.right = rec(order[mid + 1:], depth + 1)
            return node

        tree._root = rec(np.arange(pts.shape[0]), 0)
        tree.size = pts.shape[0]
        return tree

    def insert(self, point, index: Optional[int] = None) -> None:
        point = np.asarray(point, np.float64)
        idx = self.size if index is None else index
        if self._root is None:
            self._root = _Node(point, idx, 0)
        else:
            node = self._root
            while True:
                axis = node.axis
                branch = "left" if point[axis] < node.point[axis] else "right"
                nxt = getattr(node, branch)
                if nxt is None:
                    setattr(node, branch,
                            _Node(point, idx, (axis + 1) % self.dims))
                    break
                node = nxt
        self.size += 1

    def nn(self, query):
        """(distance, index) of the nearest neighbour."""
        res = self.knn(query, 1)
        return res[0] if res else None

    def knn(self, query, k: int) -> list:
        """[(distance, index)] of k nearest, ascending."""
        query = np.asarray(query, np.float64)
        heap: list = []  # max-heap via negative distance

        def rec(node):
            if node is None:
                return
            d = float(np.linalg.norm(query - node.point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = query[node.axis] - node.point[node.axis]
            near, far = (node.left, node.right) if diff < 0 \
                else (node.right, node.left)
            rec(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                rec(far)

        rec(self._root)
        return sorted((-d, i) for d, i in heap)

    def range(self, lower, upper) -> list:
        """Indices of points inside the axis-aligned box."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: list = []

        def rec(node):
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append(node.index)
            if node.point[node.axis] >= lower[node.axis]:
                rec(node.left)
            if node.point[node.axis] <= upper[node.axis]:
                rec(node.right)

        rec(self._root)
        return out
