"""Loss functions (port of ``deeplearning4j_tpu/ops/losses.py``).

Semantics follow the JAX package: the per-example loss is the SUM over
output units; the reported score is the MEAN over (unmasked) examples. A
loss takes ``(labels, preactivations, activation, weights)`` so that the
fused forms can be used (softmax + cross entropy as one log-softmax).

Only the loss the TransformerLM slice trains with is ported: ``mcxent``.
``get_loss`` raises on any other name; the rest of the JAX registry is
ROADMAP §A6.
"""

from __future__ import annotations

import torch

from deeplearning4j_torch.ops.activations import Activation

_EPS = 1e-7

_REGISTRY: dict[str, "LossFunction"] = {}


class LossFunction:
    """A named loss. ``per_example(labels, preact, activation)`` -> the
    per-example losses (``[B]``, or ``[B, T]`` per timestep)."""

    def __init__(self, name: str, fn):
        self.name = name
        self._fn = fn

    def per_example(self, labels, preact, activation: Activation,
                    weights=None):
        return self._fn(labels, preact, activation, weights)

    def score(self, labels, preact, activation: Activation, mask=None,
              weights=None):
        """Mean-over-examples loss; masked examples are left out of both
        the sum and the count."""
        per_ex = self.per_example(labels, preact, activation, weights)
        if mask is not None:
            mask = mask.reshape(per_ex.shape).to(per_ex.dtype)
            return (per_ex * mask).sum() / mask.sum().clamp_min(1.0)
        return per_ex.mean()

    def __repr__(self):  # pragma: no cover
        return f"LossFunction({self.name})"


def _register(name: str, fn) -> LossFunction:
    loss = LossFunction(name, fn)
    _REGISTRY[name] = loss
    return loss


def get_loss(name) -> LossFunction:
    if isinstance(name, LossFunction):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"loss '{name}' is not ported (ported: "
                         f"{sorted(_REGISTRY)}; the rest of the JAX "
                         "registry is ROADMAP §A6)")
    return _REGISTRY[key]


def _apply_weights(per_feature, weights):
    if weights is not None:
        per_feature = per_feature * weights
    return per_feature


def _mcxent(labels, preact, activation, weights):
    """Multi-class cross entropy; one fused log-softmax when the output
    activation is softmax."""
    if activation.name == "softmax":
        logp = torch.log_softmax(preact, dim=-1)
    else:
        logp = torch.log(torch.clamp(activation(preact), _EPS, 1.0 - _EPS))
    return -_apply_weights(labels * logp, weights).sum(dim=-1)


MCXENT = _register("mcxent", _mcxent)
