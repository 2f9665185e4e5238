"""Core feed-forward layers (port of ``nn/conf/layers/core.py``): Dense and
the Dense + loss head ``OutputLayer``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.layers.base import FeedForwardLayer
from deeplearning4j_torch.ops.losses import get_loss
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer: ``activation(x @ W + b)``, W
    ``[n_in, n_out]``.

    Serves int8-quantized weights when the params carry a ``W_scale``
    sibling (``optimize/quantize.py``): ``(x @ W_q.to(x.dtype)) * scale``,
    cast to x's dtype, plus ``b``, in the JAX layer's order and with its
    dtype promotion (a bf16 product times the f32 scale is f32, then
    cast)."""

    QUANT_PARAMS = ("W",)

    def param_order(self):
        return ["W", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        W = self._init_w(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         dtype, device)
        return {"W": W, "b": self._bias(self.n_out, dtype, device)}

    def preactivate(self, params, x):
        scale = params.get("W_scale")
        if scale is None:
            return torch.matmul(x, params["W"]) + params["b"]
        out = torch.matmul(x, params["W"].to(x.dtype)) * scale
        return out.to(x.dtype) + params["b"]

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        return self.act()(self.preactivate(params, x)), state


@register_serializable
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head. The training loss is computed from this layer's
    pre-activations, so the fused softmax/sigmoid cross-entropy forms
    apply."""

    loss: str = "mcxent"

    DEFAULT_ACTIVATION = "softmax"

    def loss_fn(self):
        return get_loss(self.loss)

    def compute_loss_per_example(self, params, x, labels, weights=None):
        pre = self.preactivate(params, x)
        return self.loss_fn().per_example(labels, pre, self.act(), weights)
