"""Normalization layers (port of ``nn/conf/layers/normalization.py``):
BatchNormalization, LocalResponseNormalization and LayerNormalization,
written out as the JAX layers write them so the two reduce alike."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import BaseLayer, Layer
from deeplearning4j_torch.utils.serde import register_serializable


@dataclass
class _FeatureAffineNorm(BaseLayer):
    """Feature-axis normalizers with learned gamma/beta: ``n_out`` from
    the channels (conv input) or the size, shape passthrough, and gamma
    and beta never regularized (no penalty, no penalty gradient)."""

    n_out: int = 0
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0

    DEFAULT_ACTIVATION = "identity"

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_out == 0:
            self.n_out = (input_type.channels
                          if input_type.kind == "convolutional"
                          else input_type.size)

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


@register_serializable
@dataclass
class BatchNormalization(_FeatureAffineNorm):
    """Batch norm over every axis but the last (``[B, F]``, ``[B, T, F]``,
    ``[B, H, W, C]``). Training normalizes by the batch mean and the
    biased batch variance and moves the running statistics as
    ``decay·old + (1 - decay)·batch`` (written out, not
    ``F.batch_norm``, whose running variance is the unbiased estimate);
    inference normalizes by the running statistics. The statistics live in
    the layer state, ``{"mean", "var"}``."""

    decay: float = 0.9
    lock_gamma_beta: bool = False
    minibatch_stats: bool = True

    def param_order(self):
        return [] if self.lock_gamma_beta else ["gamma", "beta"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        if self.lock_gamma_beta:
            return {}
        return super().init_params(gen, dtype, device)

    def init_state(self, dtype=torch.float32, device="cpu"):
        return {"mean": torch.zeros((self.n_out,), dtype=dtype,
                                    device=device),
                "var": torch.ones((self.n_out,), dtype=dtype,
                                  device=device)}

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        axes = tuple(range(x.dim() - 1))
        if train and self.minibatch_stats:
            mean = x.mean(dim=axes)
            var = ((x - mean) ** 2).mean(dim=axes)
            new_state = {
                "mean": self.decay * state["mean"] + (1.0 - self.decay) * mean,
                "var": self.decay * state["var"] + (1.0 - self.decay) * var,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            xhat = xhat * params["gamma"] + params["beta"]
        return self.act()(xhat), new_state


@register_serializable
@dataclass
class LocalResponseNormalization(Layer):
    """Across-channel LRN over the last axis: ``x / (k + alpha·S)^beta``,
    S the sum of squares over a window of ``n`` channels centred on each
    (zero beyond the ends)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        half = self.n // 2
        C = x.shape[-1]
        sq = F.pad(x * x, (half, half))
        ssum = sq[..., 0:C]
        for j in range(1, self.n):
            ssum = ssum + sq[..., j:j + C]
        return x / (self.k + self.alpha * ssum) ** self.beta, state


@register_serializable
@dataclass
class LayerNormalization(_FeatureAffineNorm):
    """Per-example normalization over the feature (last) axis with learned
    gamma/beta: biased variance, ``eps=1e-5``."""

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        return self.act()(xhat * params["gamma"] + params["beta"]), state
