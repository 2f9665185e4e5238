"""Normalization layers (port of ``nn/conf/layers/normalization.py``):
LayerNormalization only."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.layers.base import BaseLayer
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class LayerNormalization(BaseLayer):
    """Per-example normalization over the feature (last) axis with learned
    gamma/beta: biased variance, ``eps=1e-5``, written out as the JAX layer
    writes it so the two reduce in the same order. gamma and beta are never
    regularized (no penalty, no penalty gradient), as in the JAX layer."""

    n_out: int = 0
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0

    DEFAULT_ACTIVATION = "identity"

    def set_n_in(self, n_in: int) -> None:
        if self.n_out == 0:
            self.n_out = int(n_in)

    def param_order(self):
        return ["gamma", "beta"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        return {"gamma": torch.full((self.n_out,), self.gamma_init,
                                    dtype=dtype, device=device),
                "beta": torch.full((self.n_out,), self.beta_init,
                                   dtype=dtype, device=device)}

    def regularization(self, params):
        return 0.0

    def regularization_grad(self, params):
        return {}

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        return self.act()(xhat * params["gamma"] + params["beta"]), state
