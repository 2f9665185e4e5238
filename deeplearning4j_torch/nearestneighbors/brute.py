"""Device brute-force k-NN: one matmul + top-k on the card (the port of
``deeplearning4j_tpu/nearestneighbors/brute.py``).

The reference serves k-NN from a host VPTree
(nearestneighbor-server/NearestNeighbor.java over clustering/vptree/
VPTree.java:39). A VPTree prunes distance computations — the right trade
on a CPU. On an accelerator the idiomatic index is the opposite: compute
ALL distances as one [Q, N] matmul and take the top k — no tree, no
branching, batch-friendly, and exact.

The JAX package runs this as an XLA matmul and ``lax.top_k``; here it is
``torch.matmul`` and ``torch.topk``. Results are deterministic on one
device: the f32 ``EmbeddingIndex`` calls this same function, so the two are
bitwise equal. Across devices and packages the products round differently
and ``torch.topk`` promises no order among equal distances (XLA's puts the
lower index first): distances agree within rounding, and ids agree at
every rank whose distance is apart from its neighbours' by more than that.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch import resolve_device


def _knn(points, sq_norms, queries, *, k: int, metric: str):
    """(distances [Q, k], indices [Q, k] int32) nearest-first. Cosine
    points arrive pre-normalized; euclidean distances are
    ``sqrt(max(||q||^2 - 2 q.p + ||p||^2, 0))``, summed in the JAX
    package's order (the [Q, N] temporaries are updated in place)."""
    # NOTE: deliberately NOT shared with clustering.VPTree — that is the
    # host/float64 reference-style index; this is the device path.
    if metric == "cosine":
        q = queries / torch.clamp(torch.linalg.norm(queries, dim=1,
                                                    keepdim=True), min=1e-12)
        dists = (q @ points.T).neg_().add_(1.0).clamp_(min=0.0)
    else:
        qn = torch.sum(queries * queries, dim=1, keepdim=True)
        dists = (queries @ points.T).mul_(-2.0).add_(qn)
        dists = dists.add_(sq_norms[None, :]).clamp_(min=0.0)
    d, idx = torch.topk(dists, k, dim=1, largest=False, sorted=True)
    if metric != "cosine":
        d = torch.sqrt(d)
    return d, idx.to(torch.int32)


def _upload(points: np.ndarray, metric: str, device):
    """The store's device arrays: the points (normalized once for cosine)
    and their squared norms."""
    pts = torch.tensor(points, device=device)  # a copy, as JAX's upload
    if metric == "cosine":
        pts = pts / torch.clamp(torch.linalg.norm(pts, dim=1, keepdim=True),
                                min=1e-12)
    return pts, torch.sum(pts * pts, dim=1)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _check_k(k) -> None:
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
        raise ValueError(f"k must be a positive integer, got {k!r}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def _pad_queries(q: np.ndarray) -> np.ndarray:
    """Rows padded with zeros to the next power of two."""
    Q = q.shape[0]
    bucket = _pow2(Q)
    if bucket != Q:
        q = np.concatenate([q, np.zeros((bucket - Q, q.shape[1]),
                                        np.float32)])
    return q


class DeviceBruteForceIndex:
    """Exact k-NN with device-resident points (uploaded once; ``device``:
    CUDA unless the caller passes another).

    >>> index = DeviceBruteForceIndex(points)
    >>> dists, idx = index.search_batch_arrays(queries, k=5)
    """

    def __init__(self, points, metric: str = "euclidean", device=None):
        if metric not in ("euclidean", "cosine"):
            raise ValueError(f"metric must be euclidean|cosine, got {metric}")
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2:
            raise ValueError(f"points must be [N, D], got {pts.shape}")
        self.metric = metric
        self.device = resolve_device(device)
        self.points, self._sq_norms = _upload(pts, metric, self.device)

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    def search_batch_arrays(self, queries, k: int):
        """(distances [Q, k], indices [Q, k]) as numpy, nearest first.

        Query batch size AND k are padded up to power-of-two buckets, as
        the JAX package pads them (there to bound its compiled programs;
        here so both packages and the ``EmbeddingIndex`` run the same
        shapes); results are sliced back to the requested shape. ``k``
        above the point count is clamped to N; ``k < 1`` or a non-integer
        k raises ``ValueError`` before any device work."""
        _check_k(k)
        q = np.atleast_2d(np.asarray(queries, np.float32))
        k = min(int(k), self.n_points)
        Q = q.shape[0]
        kb = min(_pow2(k), self.n_points)
        with torch.inference_mode():
            d, idx = _knn(self.points, self._sq_norms,
                          torch.as_tensor(_pad_queries(q),
                                          device=self.device),
                          k=kb, metric=self.metric)
        return d.cpu().numpy()[:Q, :k], idx.cpu().numpy()[:Q, :k]

    def search_batch(self, queries, k: int) -> list:
        """VPTree.search_batch-compatible: per query a list of
        (distance, index) pairs, nearest first."""
        d, idx = self.search_batch_arrays(queries, k)
        return [[(float(dd), int(ii)) for dd, ii in zip(dr, ir)]
                for dr, ir in zip(d, idx)]

    def search(self, point, k: int):
        """[(distance, index), ...] for one query — VPTree.search shape."""
        d, idx = self.search_batch_arrays(np.asarray(point)[None, :], k)
        return [(float(dd), int(ii)) for dd, ii in zip(d[0], idx[0])]
