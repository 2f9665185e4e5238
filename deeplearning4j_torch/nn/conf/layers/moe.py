"""Mixture-of-experts layer (port of
``deeplearning4j_tpu/nn/conf/layers/moe.py``): top-k routed expert FFNs
with dense dispatch.

Every token runs through every expert and the renormalized top-k softmax
gates combine them (no capacity factor, no dropped tokens), so the result
is that of ideal sparse routing; the einsums are plain ``torch.einsum``, as
the JAX layer's are XLA einsums. ``load_balance_coef`` is an L2 pull on the
gate weights toward uniform routing (``coef · sum Wg²``, its gradient
``2 · coef · Wg`` in closed form), not the Switch auxiliary. Under
``parallel/model_sharding.py`` each model entry of a mesh computes its own
E/m experts, their gated outputs summed over ``model``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.layers.base import FeedForwardLayer
from deeplearning4j_torch.ops.activations import get_activation
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class MixtureOfExpertsLayer(FeedForwardLayer):
    """``y = sum over the top-k experts e of gate_e(x) · FFN_e(x)``, each
    expert a two-layer FFN of hidden width ``expert_hidden`` (0 takes
    ``4 · n_out``). Input ``[B, F]`` or ``[B, T, F]``."""

    n_experts: int = 4
    top_k: int = 2
    expert_hidden: int = 0
    activation: str = "relu"
    load_balance_coef: float = 0.0

    def finalize(self, g=None) -> None:
        super().finalize(g)
        if self.expert_hidden == 0:
            self.expert_hidden = 4 * self.n_out
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} not in [1, n_experts "
                             f"{self.n_experts}]")

    def param_order(self):
        return ("Wg", "W1", "b1", "W2", "b2")

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        E, D, H, O = (self.n_experts, self.n_in, self.expert_hidden,
                      self.n_out)
        return {
            "Wg": self._init_w(gen, (D, E), D, E, dtype, device),
            "W1": self._init_w(gen, (E, D, H), D, H, dtype, device),
            "b1": torch.zeros((E, H), dtype=dtype, device=device),
            "W2": self._init_w(gen, (E, H, O), H, O, dtype, device),
            "b2": torch.zeros((E, O), dtype=dtype, device=device),
        }

    def bias_param_names(self):
        return frozenset(("b1", "b2"))

    def top_k_indices(self, probs):
        """The ``top_k`` experts of each token, best first; a tie goes to
        the lower index, as ``lax.top_k`` breaks it (``torch.topk`` makes no
        promise there, and a zero token's uniform logits tie every
        expert)."""
        order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        return order[..., :self.top_k]

    def _gate(self, params, x):
        """``[..., E]`` combine weights: the softmax over every expert,
        masked to exactly ``top_k`` experts and renormalized (gradients flow
        through the kept gates)."""
        logits = torch.einsum("...d,de->...e", x, params["Wg"])
        probs = torch.softmax(logits, dim=-1)
        if self.top_k < self.n_experts:
            idx = self.top_k_indices(probs)
            mask = torch.zeros_like(probs).scatter_(-1, idx, 1.0)
            kept = probs * mask
            probs = kept / kept.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return probs

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        gates = self._gate(params, x)                       # [..., E]
        act = get_activation(self.activation)
        h = act(torch.einsum("...d,edh->...eh", x, params["W1"])
                + params["b1"])
        y = torch.einsum("...eh,eho->...eo", h, params["W2"]) + params["b2"]
        return torch.einsum("...e,...eo->...o", gates, y), state

    def regularization(self, params):
        reg = super().regularization(params)
        if self.load_balance_coef:
            reg = reg + self.load_balance_coef * (params["Wg"] ** 2).sum()
        return reg

    def regularization_grad(self, params):
        out = super().regularization_grad(params)
        # the closed form of coef · sum(Wg²): no 0.5, unlike the l2 form
        if self.load_balance_coef and "Wg" in params:
            g = 2.0 * self.load_balance_coef * params["Wg"]
            out["Wg"] = out.get("Wg", 0) + g
        return out
