"""Restricted Boltzmann machine with CD-k pretraining (port of
``deeplearning4j_tpu/nn/conf/layers/rbm.py``).

The CD-k update is the autograd gradient of an energy surrogate

    e(v0, h0_prob) - e(vk_prob, hk_prob),
    e(v, h) = -(sum(h * (v @ W)) + h . hb + v . vb)

with the Gibbs chain detached (constant under the gradient, as CD
prescribes), so the RBM trains through the same pretrain step as the
autoencoders. The chain advances on hidden samples and the statistics use
probabilities; sample i draws from ``fold_in(rng, i)``, JAX's keys, so a
binary unit is JAX's sample wherever the two sigmoids agree (an f32 draw
that falls between torch's and XLA's sigmoid of a unit flips it).

Unit types: hidden binary | rectified | gaussian | identity, visible
binary | gaussian | linear | identity ("softmax" is rejected, as in the
JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.layers.base import FeedForwardLayer
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.utils.serde import register_serializable

_HIDDEN_UNITS = ("binary", "rectified", "gaussian", "identity")
_VISIBLE_UNITS = ("binary", "gaussian", "linear", "identity")


@register_serializable
@dataclass
class RBM(FeedForwardLayer):
    """RBM pretrain layer. The supervised forward is the hidden mean
    (``prop_up``), so a pretrained RBM slots into a feed-forward stack."""

    hidden_unit: str = "binary"
    visible_unit: str = "binary"
    k: int = 1
    sparsity: float = 0.0

    def validate(self) -> None:
        super().validate()
        if self.hidden_unit not in _HIDDEN_UNITS:
            raise ValueError(f"hidden_unit must be one of {_HIDDEN_UNITS}, "
                             f"got '{self.hidden_unit}'")
        if self.visible_unit not in _VISIBLE_UNITS:
            raise ValueError(f"visible_unit must be one of "
                             f"{_VISIBLE_UNITS}, got '{self.visible_unit}'")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    def param_order(self):
        return ["W", "b", "vb"]

    def bias_param_names(self):
        return frozenset({"b", "vb"})

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        W = self._init_w(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         dtype, device)
        return {"W": W, "b": self._bias(self.n_out, dtype, device),
                "vb": torch.zeros(self.n_in, dtype=dtype, device=device)}

    # ------------------------------------------------------------- units
    def _hidden_mean(self, pre):
        if self.hidden_unit == "binary":
            return torch.sigmoid(pre)
        if self.hidden_unit == "rectified":
            return torch.relu(pre)
        return pre            # gaussian, identity: the mean is pre

    def _hidden_sample(self, rng, pre, mean):
        if self.hidden_unit == "binary":
            return random.bernoulli(rng, mean).to(mean.dtype)
        if self.hidden_unit == "rectified":
            # NReLU: max(0, pre + N(0, 1)·sqrt(sigmoid(pre)))
            noise = random.normal(rng, pre.shape, pre.dtype)
            return torch.relu(pre + noise * torch.sqrt(torch.sigmoid(pre)))
        if self.hidden_unit == "gaussian":
            return mean + random.normal(rng, pre.shape, pre.dtype)
        return mean           # identity: deterministic

    def _visible_mean(self, pre):
        if self.visible_unit == "binary":
            return torch.sigmoid(pre)
        return pre            # gaussian, linear, identity

    # --------------------------------------------------------- propagation
    def prop_up(self, params, v):
        """The hidden mean given the visible units."""
        return self._hidden_mean(torch.matmul(v, params["W"]) + params["b"])

    def prop_down(self, params, h):
        """The visible mean given the hidden units."""
        return self._visible_mean(torch.matmul(h, params["W"].T)
                                  + params["vb"])

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        return self.prop_up(params, x), state

    # ------------------------------------------------------------ CD-k
    @torch.no_grad()
    def _gibbs_chain(self, params, v0, rng):
        """k alternating Gibbs steps from ``v0``; returns ``(h0_prob,
        vk_prob, hk_prob)``, outside autograd."""
        pre0 = torch.matmul(v0, params["W"]) + params["b"]
        h0_prob = self._hidden_mean(pre0)
        h_sample = self._hidden_sample(random.fold_in(rng, 0), pre0,
                                       h0_prob)
        v_prob = h_prob = None
        for i in range(self.k):
            v_prob = self.prop_down(params, h_sample)
            pre = torch.matmul(v_prob, params["W"]) + params["b"]
            h_prob = self._hidden_mean(pre)
            if i + 1 < self.k:
                h_sample = self._hidden_sample(random.fold_in(rng, i + 1),
                                               pre, h_prob)
        return h0_prob, v_prob, h_prob

    def pretrain_loss_per_example(self, params, x, rng):
        """Per-example CD-k surrogate whose gradient is the CD-k update.
        Its value is the reconstruction error ``||v0 - vk_prob||²``,
        grafted on as ``surrogate + (display - surrogate).detach()``."""
        h0_prob, vk_prob, hk_prob = self._gibbs_chain(params, x, rng)
        W = params["W"]
        # -(pos - neg) per statistic: descent on it ascends (pos - neg)
        w_term = ((hk_prob * torch.matmul(vk_prob, W)).sum(dim=-1)
                  - (h0_prob * torch.matmul(x, W)).sum(dim=-1))
        vb_term = torch.matmul(vk_prob - x, params["vb"])
        if self.sparsity != 0.0:
            # with sparsity the hb gradient is (sparsity - h0_prob): the
            # negative phase is dropped
            hb_term = (torch.matmul(h0_prob, params["b"])
                       - self.sparsity * params["b"].sum())
        else:
            hb_term = torch.matmul(hk_prob - h0_prob, params["b"])
        surrogate = w_term + hb_term + vb_term
        display = ((x - vk_prob) ** 2).sum(dim=-1)
        return surrogate + (display - surrogate).detach()
