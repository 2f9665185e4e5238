"""FrozenLayer and CenterLossOutputLayer (port of
``nn/conf/layers/misc.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import Layer
from deeplearning4j_torch.nn.conf.layers.core import OutputLayer
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class FrozenLayer(Layer):
    """Wraps a layer whose parameters get no gradient (detached, JAX's
    ``stop_gradient``), run with inference semantics (no dropout)."""

    inner: Optional[Layer] = None

    def output_type(self, input_type: InputType) -> InputType:
        return self.inner.output_type(input_type)

    def set_n_in(self, input_type: InputType) -> None:
        self.inner.set_n_in(input_type)

    def param_order(self):
        return self.inner.param_order()

    def validate(self) -> None:
        self.inner.validate()

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        return self.inner.init_params(gen, dtype, device)

    def init_state(self, dtype=torch.float32, device="cpu"):
        return self.inner.init_state(dtype, device)

    def feed_forward_mask(self, mask):
        return self.inner.feed_forward_mask(mask)

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        frozen = {k: v.detach() for k, v in params.items()}
        return self.inner.forward(frozen, state, x, mask=mask, train=False,
                                  rng=rng)


@register_serializable
@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss: ``mcxent + (lambda/2)·||x - c_label||²``. The
    class centers ``[n_out, n_in]`` live in the layer state and move by
    ``update_centers`` after each step, outside the gradient."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_state(self, dtype=torch.float32, device="cpu"):
        return {"centers": torch.zeros((self.n_out, self.n_in), dtype=dtype,
                                       device=device)}

    def compute_loss_per_example(self, params, x, labels, weights=None,
                                 state=None):
        base = super().compute_loss_per_example(params, x, labels, weights)
        if state is None:
            return base
        assigned = torch.matmul(labels, state["centers"].detach())
        return base + 0.5 * self.lambda_ * ((x - assigned) ** 2).sum(dim=-1)

    def update_centers(self, state, x, labels):
        """``c_j += alpha · mean over the examples of class j of (x_i -
        c_j)``, from one-hot ``labels``."""
        centers = state["centers"]
        counts = labels.sum(dim=0).clamp_min(1.0)[:, None]
        assigned = torch.matmul(labels, centers)
        diff_sum = torch.matmul(labels.T, x - assigned)
        return {**state, "centers": centers + self.alpha * diff_sum / counts}
