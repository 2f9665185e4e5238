"""Layer base classes (port of ``deeplearning4j_tpu/nn/conf/layers/base.py``).

The contract stays functional, as in the JAX package:

- ``init_params(gen, dtype, device) -> dict[str, Tensor]``;
- ``forward(params, state, x, *, mask) -> (out, new_state)``.

The layers carry the JAX package's config fields (so its JSON loads field
for field); what they do is the TransformerLM slice's: ``n_in``/``n_out``
inference from the previous vertex's feature size, ``bias_init``, xavier
weight init and the activation lookup. A field the port cannot honour yet
raises where it would act.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_torch.ops.activations import Activation, get_activation


@dataclass
class Layer:
    """Base for all layer configs. The fields are the JAX package's, so a
    ``configuration.json`` it wrote loads here field for field. ``dropout``
    and ``gradient_normalization`` act only in training, where the port
    refuses them (``optimize/fused_fit.py``)."""

    name: Optional[str] = None
    dropout: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    #: True for layers that carry streaming state (KV pages or a position
    #: counter) through a serving carry
    STREAMS = False

    def finalize(self) -> None:
        """Fill None fields with the defaults the JAX package's builder
        gives a layer that inherits nothing from a global conf."""
        if self.dropout is None:
            self.dropout = 0.0
        if self.gradient_normalization is None:
            self.gradient_normalization = "none"
        if self.gradient_normalization_threshold is None:
            self.gradient_normalization_threshold = 1.0

    def set_n_in(self, n_in: int) -> None:
        """Infer nIn-like fields from the previous vertex's feature size."""

    def output_size(self, n_in: int) -> int:
        return n_in

    def param_order(self) -> list[str]:
        """Parameter names in the flat-vector order (``params_flat``)."""
        return []

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device="cpu") -> dict:
        return {}

    def forward(self, params: dict, state: dict, x, *, mask=None):
        raise NotImplementedError


@dataclass
class BaseLayer(Layer):
    """Layers with weights: activation, weight and bias init, and the
    regularization and per-layer learning-rate fields (refused in training
    until ported, ROADMAP A6)."""

    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[object] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None

    DEFAULT_ACTIVATION = "sigmoid"

    def finalize(self) -> None:
        super().finalize()
        if self.activation is None:
            self.activation = self.DEFAULT_ACTIVATION
        if self.weight_init is None:
            self.weight_init = "xavier"
        if self.bias_init is None:
            self.bias_init = 0.0
        for f in ("l1", "l2", "l1_bias", "l2_bias"):
            if getattr(self, f) is None:
                setattr(self, f, 0.0)

    def act(self) -> Activation:
        return get_activation(self.activation or self.DEFAULT_ACTIVATION)

    def _init_w(self, gen, shape, fan_in, fan_out, dtype, device):
        """Xavier normal init, ``N(0, 2 / (fan_in + fan_out))`` as the JAX
        package's ``init_weight`` draws it. The numbers differ from
        ``jax.random``'s; parity tests load the reference's weights. Other
        schemes (``weight_init``, ``dist``) are not ported and raise here,
        where they would act. ``gen=None`` draws nothing: zeros of the
        shape, for weights about to be loaded."""
        if gen is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        if (self.weight_init or "xavier") != "xavier" or \
                self.dist is not None:
            raise NotImplementedError(
                f"layer '{self.name or type(self).__name__}': weight_init="
                f"{self.weight_init!r}, dist={self.dist!r}: only xavier "
                "init is ported (ROADMAP A6); load the weights instead")
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        w = w * math.sqrt(2.0 / (fan_in + fan_out))
        return w.to(device=device, dtype=dtype)

    def _bias(self, n, dtype, device):
        return torch.full((n,), float(self.bias_init or 0.0), dtype=dtype,
                          device=device)


@dataclass
class FeedForwardLayer(BaseLayer):
    """Dense-style layers with explicit nIn/nOut."""

    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, n_in: int) -> None:
        if self.n_in == 0:
            self.n_in = int(n_in)

    def output_size(self, n_in: int) -> int:
        return self.n_out
