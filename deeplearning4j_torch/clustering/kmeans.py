"""KMeans clustering (the port of ``deeplearning4j_tpu/clustering/kmeans.py``;
reference: deeplearning4j-core clustering/kmeans/KMeansClustering.java +
the iteration machinery under clustering/algorithm/).

Each Lloyd iteration is a handful of device calls: the [N, K] squared
distances through one matmul, the argmin assignment, and the centroid
update as a one-hot product (``one_hot.T @ x``: a fixed summation order,
so a rebuild on the same card is bitwise; ``index_add_`` would sum through
atomics in whatever order the card runs them). The initial centers are the
same numpy ``default_rng(seed)`` draw as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch import resolve_device


def _lloyd_iteration(x, centers, *, k: int):
    """One Lloyd step: (new centers [K, D], assignment [N], cost)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    d2 = x2 - 2.0 * (x @ centers.T) + c2
    assign = torch.argmin(d2, dim=1)
    one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # [N, K]
    counts = one_hot.sum(dim=0)                                    # [K]
    sums = one_hot.T @ x                                           # [K, D]
    new_centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    cost = torch.sum(torch.min(d2, dim=1).values)
    return new_centers, assign, cost


class KMeansClustering:
    """reference: KMeansClustering.setup(k, maxIterations, distanceFn).
    ``device``: where the iterations run (CUDA unless the caller passes
    another device)."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-6,
                 seed: int = 0, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centers: np.ndarray = None
        self.cost: float = float("inf")

    def apply_to(self, points) -> np.ndarray:
        """Cluster; returns per-point assignments (reference: applyTo ->
        ClusterSet)."""
        x = torch.as_tensor(np.asarray(points, np.float32),
                            device=self.device)
        n = x.shape[0]
        rng = np.random.default_rng(self.seed)
        init_idx = rng.choice(n, self.k, replace=False)
        centers = x[torch.as_tensor(init_idx, device=self.device)]
        prev_cost = float("inf")
        assign = None
        for _ in range(self.max_iterations):
            centers, assign, cost_t = _lloyd_iteration(x, centers, k=self.k)
            cost = float(cost_t)
            if abs(prev_cost - cost) < self.tol:
                break
            prev_cost = cost
        self.centers = centers.cpu().numpy()
        self.cost = cost
        return assign.cpu().numpy()

    def predict(self, points) -> np.ndarray:
        x = np.asarray(points, np.float32)
        d2 = ((x[:, None, :] - self.centers[None, :, :]) ** 2).sum(-1)
        return d2.argmin(axis=1)
