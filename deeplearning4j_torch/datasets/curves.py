"""The curves set for deep-autoencoder pretraining (port of
``deeplearning4j_tpu/datasets/curves.py``, which imports no JAX; the port
keeps its own copy).

28 × 28 grayscale images of smooth curves, GENERATED from a seed (a chain
of quadratic Béziers through random control points, splatted bilinearly,
intensities in [0, 1]), served as DataSets whose labels are the features
(reconstruction targets). A local ``curves.npz`` (a ``features`` array,
[N, 784] float) is used instead when present in ``path``, ``CURVES_DIR``
or ``~/.curves``. The same arguments give the JAX package's arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.iterators import ListDataSetIterator

SIDE = 28


def _rasterize_curve(rng: np.random.Generator) -> np.ndarray:
    """One 28 × 28 curve: two quadratic Béziers through 4 random control
    points (the second's middle point the first's reflected), drawn with
    bilinear splatting."""
    img = np.zeros((SIDE, SIDE), np.float32)
    pts = rng.uniform(3, SIDE - 3, size=(4, 2))
    segments = [(pts[0], pts[1], pts[2]), (pts[2], pts[3],
                                           2 * pts[3] - pts[1])]
    t = np.linspace(0.0, 1.0, 64)[:, None]
    for p0, p1, p2 in segments:
        xy = ((1 - t) ** 2) * p0 + 2 * (1 - t) * t * p1 + (t ** 2) * p2
        for x, y in xy:
            xi, yi = int(np.floor(x)), int(np.floor(y))
            fx, fy = x - xi, y - yi
            for dx, wx in ((0, 1 - fx), (1, fx)):
                for dy, wy in ((0, 1 - fy), (1, fy)):
                    xj, yj = xi + dx, yi + dy
                    if 0 <= xj < SIDE and 0 <= yj < SIDE:
                        img[yj, xj] = min(1.0, img[yj, xj] + wx * wy)
    return img


def synthetic_curves(n: int, seed: int = 7) -> np.ndarray:
    """[n, 784] float32 in [0, 1], deterministic in (n, seed)."""
    rng = np.random.default_rng(seed)
    return np.stack([_rasterize_curve(rng).ravel() for _ in range(n)])


def _find_file(path: Optional[str]):
    for d in (path, os.environ.get("CURVES_DIR"),
              os.path.expanduser("~/.curves")):
        if d:
            f = os.path.join(d, "curves.npz")
            if os.path.exists(f):
                return f
    return None


class CurvesDataSetIterator(ListDataSetIterator):
    """Batches of curve images with labels equal to the features."""

    def __init__(self, batch_size: int = 128, num_examples: int = 2048,
                 path: Optional[str] = None, seed: int = 7):
        f = _find_file(path)
        if f is not None:
            feats = np.load(f)["features"][:num_examples].astype(np.float32)
        else:
            feats = synthetic_curves(num_examples, seed)
        batches = [DataSet(feats[i:i + batch_size], feats[i:i + batch_size])
                   for i in range(0, len(feats), batch_size)]
        super().__init__(batches, batch_size=batch_size)
