"""Core feed-forward layers (port of ``nn/conf/layers/core.py``): Dense."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.layers.base import FeedForwardLayer
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer: ``activation(x @ W + b)``, W
    ``[n_in, n_out]``."""

    def param_order(self):
        return ["W", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        W = self._init_w(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         dtype, device)
        return {"W": W, "b": self._bias(self.n_out, dtype, device)}

    def preactivate(self, params, x):
        return torch.matmul(x, params["W"]) + params["b"]

    def forward(self, params, state, x, *, mask=None):
        return self.act()(self.preactivate(params, x)), state
