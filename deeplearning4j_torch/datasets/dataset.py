"""DataSet container (port of the part of
``deeplearning4j_tpu/datasets/dataset.py`` that ``fit`` reads).

Arrays stay where the caller put them: numpy arrays (as in the JAX package)
are copied to the net's device at each step; tensors already on the device
are used as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def _keep(a):
    if a is None or torch.is_tensor(a):
        return a
    return np.asarray(a)


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
