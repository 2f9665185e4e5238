"""Loss functions (port of ``deeplearning4j_tpu/ops/losses.py``).

Semantics follow the JAX package: the per-example loss is the SUM over
output units; the reported score is the MEAN over (unmasked) examples. A
loss takes ``(labels, preactivations, activation, weights)`` so that the
fused forms can be used (softmax + cross entropy as one log-softmax,
sigmoid + binary cross entropy in the stable form). Every loss of the JAX
registry is here under its names; probabilities taken from an activation
are clipped as JAX clips them (``_EPS``).
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

    def __eq__(self, other):
        return isinstance(other, LossFunction) and other.name == self.name

    def __hash__(self):
        return hash(self.name)


def _register(name: str, fn) -> LossFunction:
    loss = LossFunction(name, fn)
    _REGISTRY[name] = loss
    return loss


def get_loss(name) -> LossFunction:
    if isinstance(name, LossFunction):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name}'. Known: "
                         f"{sorted(_REGISTRY)}")
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


def _xent(labels, preact, activation, weights):
    """Binary cross entropy (per unit), in the stable fused form
    ``max(x, 0) - x·z + log1p(exp(-|x|))`` under a sigmoid output."""
    if activation.name == "sigmoid":
        x = preact
        per = (torch.clamp(x, min=0.0) - x * labels
               + torch.log1p(torch.exp(-torch.abs(x))))
    else:
        p = torch.clamp(activation(preact), _EPS, 1.0 - _EPS)
        per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return _apply_weights(per, weights).sum(dim=-1)


def _mse(labels, preact, activation, weights):
    out = activation(preact)
    return (_apply_weights((labels - out) ** 2, weights).sum(dim=-1)
            / labels.shape[-1])


def _sse(labels, preact, activation, weights):
    out = activation(preact)
    return _apply_weights((labels - out) ** 2, weights).sum(dim=-1)


def _mae(labels, preact, activation, weights):
    out = activation(preact)
    return (_apply_weights(torch.abs(labels - out), weights).sum(dim=-1)
            / labels.shape[-1])


def _l1(labels, preact, activation, weights):
    out = activation(preact)
    return _apply_weights(torch.abs(labels - out), weights).sum(dim=-1)


def _mape(labels, preact, activation, weights):
    out = activation(preact)
    denom = torch.where(torch.abs(labels) < _EPS,
                        torch.full_like(labels, _EPS), labels)
    per = torch.abs((labels - out) / denom) * 100.0
    return _apply_weights(per, weights).sum(dim=-1) / labels.shape[-1]


def _msle(labels, preact, activation, weights):
    out = activation(preact)
    per = (torch.log1p(torch.clamp(out, min=-1.0 + _EPS))
           - torch.log1p(torch.clamp(labels, min=-1.0 + _EPS))) ** 2
    return _apply_weights(per, weights).sum(dim=-1) / labels.shape[-1]


def _kld(labels, preact, activation, weights):
    out = torch.clamp(activation(preact), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    per = lab * (torch.log(lab) - torch.log(out))
    return _apply_weights(per, weights).sum(dim=-1)


def _nll(labels, preact, activation, weights):
    # the reference aliases NEGATIVELOGLIKELIHOOD to MCXENT
    return _mcxent(labels, preact, activation, weights)


def _poisson(labels, preact, activation, weights):
    out = torch.clamp(activation(preact), min=_EPS)
    per = out - labels * torch.log(out)
    return _apply_weights(per, weights).sum(dim=-1)


def _cosine(labels, preact, activation, weights):
    out = activation(preact)
    dot = (out * labels).sum(dim=-1)
    norm = (torch.linalg.vector_norm(out, dim=-1)
            * torch.linalg.vector_norm(labels, dim=-1))
    return 1.0 - dot / torch.clamp(norm, min=_EPS)


def _hinge(labels, preact, activation, weights):
    # labels in {-1, +1}
    out = activation(preact)
    return _apply_weights(torch.clamp(1.0 - labels * out, min=0.0),
                          weights).sum(dim=-1)


def _squared_hinge(labels, preact, activation, weights):
    out = activation(preact)
    return _apply_weights(torch.clamp(1.0 - labels * out, min=0.0) ** 2,
                          weights).sum(dim=-1)


MCXENT = _register("mcxent", _mcxent)
NEGATIVELOGLIKELIHOOD = _register("negativeloglikelihood", _nll)
XENT = _register("xent", _xent)
MSE = _register("mse", _mse)
SQUARED_LOSS = _register("squared_loss", _sse)
MEAN_ABSOLUTE_ERROR = _register("mean_absolute_error", _mae)
L1 = _register("l1", _l1)
L2 = _register("l2", _sse)
MEAN_ABSOLUTE_PERCENTAGE_ERROR = _register("mean_absolute_percentage_error",
                                           _mape)
MEAN_SQUARED_LOGARITHMIC_ERROR = _register("mean_squared_logarithmic_error",
                                           _msle)
KL_DIVERGENCE = _register("kl_divergence", _kld)
RECONSTRUCTION_CROSSENTROPY = _register("reconstruction_crossentropy", _xent)
POISSON = _register("poisson", _poisson)
COSINE_PROXIMITY = _register("cosine_proximity", _cosine)
HINGE = _register("hinge", _hinge)
SQUARED_HINGE = _register("squared_hinge", _squared_hinge)
