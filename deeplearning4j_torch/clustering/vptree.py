"""Vantage-point tree for k-NN (the port of
``deeplearning4j_tpu/clustering/vptree.py``; reference: deeplearning4j-core
clustering/vptree/VPTree.java:39 — metric-space search used by the
nearest-neighbor server and t-SNE).

Build: recursive random-vantage median partitioning (numpy). Queries: exact
k-NN with triangle-inequality pruning. ``search_batch`` offers the
device alternative: brute-force [Q, N] distance matmul on the card — for
the server's batched queries this beats pointer-chasing.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


def _distances(metric, a, b):
    if metric == "euclidean":
        return np.linalg.norm(b - a, axis=-1)
    if metric == "cosine":
        an = a / max(np.linalg.norm(a), 1e-12)
        bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
        return 1.0 - bn @ an
    raise ValueError(f"Unknown metric '{metric}'")


class VPTree:
    def __init__(self, points, metric: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, np.float64)
        self.metric = metric
        rng = np.random.default_rng(seed)
        self._root = self._build(np.arange(self.points.shape[0]), rng)

    def _build(self, idx: np.ndarray, rng) -> Optional[_VPNode]:
        if idx.size == 0:
            return None
        vp_pos = rng.integers(idx.size)
        vp = idx[vp_pos]
        rest = np.delete(idx, vp_pos)
        node = _VPNode(int(vp))
        if rest.size == 0:
            return node
        d = _distances(self.metric, self.points[vp], self.points[rest])
        median = float(np.median(d))
        node.threshold = median
        node.inside = self._build(rest[d <= median], rng)
        node.outside = self._build(rest[d > median], rng)
        return node

    def search(self, query, k: int) -> list:
        """[(distance, index)] of the k nearest, ascending (reference:
        VPTree.search)."""
        query = np.asarray(query, np.float64)
        heap: list = []  # max-heap (-d, idx)
        tau = [np.inf]

        def rec(node):
            if node is None:
                return
            d = float(_distances(self.metric, query,
                                 self.points[node.index][None])[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                rec(node.inside)
                if d + tau[0] >= node.threshold:
                    rec(node.outside)
            else:
                rec(node.outside)
                if d - tau[0] <= node.threshold:
                    rec(node.inside)

        rec(self._root)
        return sorted((-d, i) for d, i in heap)

    def search_batch(self, queries, k: int, device=None) -> list:
        """Brute-force batched k-NN on the card: one [Q, N] distance matrix
        + top-k (``device``: CUDA unless the caller passes another)."""
        dev = resolve_device(device)
        q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        p = torch.as_tensor(self.points.astype(np.float32), device=dev)
        if self.metric == "euclidean":
            d2 = (torch.sum(q * q, 1)[:, None] - 2.0 * q @ p.T
                  + torch.sum(p * p, 1)[None, :])
            d = torch.sqrt(torch.clamp(d2, min=0.0))
        else:
            qn = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True),
                                 min=1e-12)
            pn = p / torch.clamp(torch.linalg.norm(p, dim=1, keepdim=True),
                                 min=1e-12)
            d = 1.0 - qn @ pn.T
        vals, idx = torch.topk(d, k, dim=1, largest=False)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        return [list(zip(vals[i].tolist(), idx[i].tolist()))
                for i in range(q.shape[0])]
