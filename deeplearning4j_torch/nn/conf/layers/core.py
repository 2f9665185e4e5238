"""Core feed-forward layers (port of ``nn/conf/layers/core.py``): Dense, the
Dense + loss head ``OutputLayer``, the loss-only ``LossLayer``,
``ActivationLayer``, ``DropoutLayer``, ``EmbeddingLayer`` and the
denoising ``AutoEncoder`` (trained by ``MultiLayerNetwork.pretrain``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.layers.base import (BaseLayer,
                                                      FeedForwardLayer)
from deeplearning4j_torch.ops import random
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


@register_serializable
@dataclass
class LossLayer(BaseLayer):
    """Loss-only head with no parameters: the loss of the activation of
    its input."""

    loss: str = "mcxent"

    DEFAULT_ACTIVATION = "identity"

    def loss_fn(self):
        return get_loss(self.loss)

    def preactivate(self, params, x):
        return x

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        return self.act()(x), state

    def compute_loss_per_example(self, params, x, labels, weights=None):
        return self.loss_fn().per_example(labels, x, self.act(), weights)


@register_serializable
@dataclass
class ActivationLayer(BaseLayer):
    """The activation alone, no parameters."""

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        return self.act()(x), state


@register_serializable
@dataclass
class DropoutLayer(BaseLayer):
    """Dropout alone (its input dropout), no parameters."""

    DEFAULT_ACTIVATION = "identity"

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        return self.act()(x), state


@register_serializable
@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index lookup: integer inputs ``[B]`` or ``[B, 1]`` select rows of W
    ``[n_in, n_out]``, plus the bias."""

    DEFAULT_ACTIVATION = "identity"

    def param_order(self):
        return ["W", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        W = self._init_w(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         dtype, device)
        return {"W": W, "b": self._bias(self.n_out, dtype, device)}

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        idx = x.to(torch.int64)
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        return self.act()(params["W"][idx] + params["b"]), state


@register_serializable
@dataclass
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder. The supervised forward is the encoder
    (``activation(x @ W + b)``); layer-wise pretraining minimizes
    ``reconstruction_loss_per_example``: the input corrupted by a
    keep-mask ``bernoulli(rng, 1 - corruption_level, x.shape)`` (JAX's
    draw bit for bit), encoded, decoded through ``Wᵀ`` and the visible bias
    ``vb``, and scored by ``loss`` against the clean input."""

    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def param_order(self):
        return ["W", "b", "vb"]

    def bias_param_names(self):
        return frozenset({"b", "vb"})

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        W = self._init_w(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         dtype, device)
        return {"W": W, "b": self._bias(self.n_out, dtype, device),
                "vb": torch.zeros(self.n_in, dtype=dtype, device=device)}

    def preactivate(self, params, x):
        return torch.matmul(x, params["W"]) + params["b"]

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        return self.act()(self.preactivate(params, x)), state

    def reconstruction_loss_per_example(self, params, x, rng=None):
        corrupted = x
        if rng is not None and self.corruption_level > 0:
            keep = random.bernoulli(rng, 1.0 - self.corruption_level,
                                    x.shape)
            corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        hidden = self.act()(self.preactivate(params, corrupted))
        recon_pre = torch.matmul(hidden, params["W"].T) + params["vb"]
        return get_loss(self.loss).per_example(x, recon_pre, self.act(),
                                               None)
