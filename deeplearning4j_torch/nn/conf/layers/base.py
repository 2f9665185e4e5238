"""Layer base classes (port of ``deeplearning4j_tpu/nn/conf/layers/base.py``).

The contract stays functional, as in the JAX package:

- ``init_params(gen, dtype, device) -> dict[str, Tensor]``;
- ``forward(params, state, x, *, mask) -> (out, new_state)``.

Only the pieces the TransformerLM slice needs are ported: ``n_in``/``n_out``
inference from the previous vertex's feature size, ``bias_init``, xavier
weight init and the activation lookup.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_torch.ops.activations import Activation, get_activation


@dataclass
class Layer:
    """Base for all layer configs."""

    name: Optional[str] = None

    #: True for layers that carry streaming state (KV pages or a position
    #: counter) through a serving carry
    STREAMS = False

    def finalize(self) -> None:
        """Fill None fields with the per-class defaults."""

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
    """Layers with weights: activation and bias init (weights are always
    xavier, the TransformerLM conf's global init)."""

    activation: Optional[str] = None
    bias_init: Optional[float] = None

    DEFAULT_ACTIVATION = "sigmoid"

    def finalize(self) -> None:
        if self.activation is None:
            self.activation = self.DEFAULT_ACTIVATION
        if self.bias_init is None:
            self.bias_init = 0.0

    def act(self) -> Activation:
        return get_activation(self.activation or self.DEFAULT_ACTIVATION)

    def _init_w(self, gen, shape, fan_in, fan_out, dtype, device):
        """Xavier normal init, ``N(0, 2 / (fan_in + fan_out))`` as the JAX
        package's ``init_weight`` draws it. The numbers differ from
        ``jax.random``'s; parity tests load the reference's weights."""
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
