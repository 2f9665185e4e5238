"""Recurrent-family layers (port of ``nn/conf/layers/recurrent.py``):
RnnOutputLayer."""

from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_torch.nn.conf.layers.core import DenseLayer
from deeplearning4j_torch.ops.losses import get_loss
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class RnnOutputLayer(DenseLayer):
    """Per-timestep dense + loss over ``[B, T, F]``. A ``[B, T]`` label mask
    leaves masked steps out of the loss mean."""

    loss: str = "mcxent"

    DEFAULT_ACTIVATION = "softmax"

    def loss_fn(self):
        return get_loss(self.loss)

    def compute_loss_per_example(self, params, x, labels, weights=None):
        """``[B, T]`` losses of the preactivations against ``labels``."""
        pre = self.preactivate(params, x)
        return self.loss_fn().per_example(labels, pre, self.act(), weights)
