"""Recurrent-family layers (port of ``nn/conf/layers/recurrent.py``):
RnnOutputLayer, forward only."""

from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_torch.nn.conf.layers.core import DenseLayer


@dataclass
class RnnOutputLayer(DenseLayer):
    """Per-timestep dense over ``[B, T, F]`` followed by softmax. The loss
    head belongs to the training slice and is not ported yet."""

    DEFAULT_ACTIVATION = "softmax"
