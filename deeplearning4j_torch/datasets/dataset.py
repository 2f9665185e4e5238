"""DataSet and MultiDataSet containers (port of
``deeplearning4j_tpu/datasets/dataset.py``).

Arrays stay where the caller put them: numpy arrays (as in the JAX package)
are copied to the net's device at each step (a fused fit block copies its
K batches at once, ahead of use); tensors already on the device are used
as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _keep(a):
    if a is None or torch.is_tensor(a):
        return a
    return np.asarray(a)


def _take(a, idx):
    """Rows ``idx`` (a slice or an index array) of a numpy array or a
    tensor (None stays None)."""
    if a is None:
        return None
    if torch.is_tensor(a) and not isinstance(idx, slice):
        idx = torch.as_tensor(idx, device=a.device)
    return a[idx]


def _concat(arrays):
    if arrays[0] is None:
        return None
    if any(torch.is_tensor(a) for a in arrays):
        return torch.cat([torch.as_tensor(a) for a in arrays])
    return np.concatenate(arrays)


class DataSet:
    """features [B, ...], labels [B, ...], optional masks [B, T]."""

    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = _keep(features)
        self.labels = _keep(labels)
        self.features_mask = _keep(features_mask)
        self.labels_mask = _keep(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    @classmethod
    def on_device(cls, features, labels=None, features_mask=None,
                  labels_mask=None) -> "DataSet":
        """A DataSet around arrays already placed (tensors on a device, or
        ``parallel/mesh.py::ShardedArray`` pieces over a mesh), kept as
        they are: JAX's ``on_device``, which skips the constructor's
        ``np.asarray``."""
        ds = cls.__new__(cls)
        ds.features = features
        ds.labels = labels
        ds.features_mask = features_mask
        ds.labels_mask = labels_mask
        return ds

    def _rows(self, idx) -> "DataSet":
        return DataSet(_take(self.features, idx), _take(self.labels, idx),
                       _take(self.features_mask, idx),
                       _take(self.labels_mask, idx))

    def split_test_and_train(self, n_train: int):
        return (self._rows(slice(None, n_train)),
                self._rows(slice(n_train, None)))

    def shuffle(self, seed: Optional[int] = None):
        """Permute the rows in place (numpy's ``default_rng(seed)``
        permutation, the JAX package's)."""
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        shuffled = self._rows(idx)
        self.features, self.labels = shuffled.features, shuffled.labels
        self.features_mask = shuffled.features_mask
        self.labels_mask = shuffled.labels_mask

    def batch_by(self, batch_size: int):
        n = self.num_examples()
        for s in range(0, n, batch_size):
            yield self._rows(slice(s, min(s + batch_size, n)))

    @staticmethod
    def merge(datasets):
        return DataSet(_concat([d.features for d in datasets]),
                       _concat([d.labels for d in datasets]),
                       _concat([d.features_mask for d in datasets]),
                       _concat([d.labels_mask for d in datasets]))


class MultiDataSet:
    """Several feature and label arrays, parallel to a ComputationGraph's
    inputs and outputs."""

    def __init__(self, features, labels, features_masks=None,
                 labels_masks=None):
        self.features = [_keep(f) for f in _as_list(features)]
        self.labels = [_keep(y) for y in _as_list(labels)]
        self.features_masks = ([None] * len(self.features)
                               if features_masks is None
                               else [_keep(m) for m in
                                     _as_list(features_masks)])
        self.labels_masks = ([None] * len(self.labels) if labels_masks is None
                             else [_keep(m) for m in _as_list(labels_masks)])

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]
