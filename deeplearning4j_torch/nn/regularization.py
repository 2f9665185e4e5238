"""L1/L2 regularization (port of ``deeplearning4j_tpu/nn/regularization.py``).

The net's ``_loss`` reports the penalty VALUE (``penalty_value``, computed
with no gradient) and the train step adds its closed-form gradient
``l2·W + l1·sign(W)`` to the data-loss gradients
(``add_regularization_grads``), before the finite check and before
gradient normalization, as the JAX step core orders them. The JAX package
has no separate weight-decay field: its decay is ``l2`` (``l2_bias`` for
biases), applied this way.
"""

from __future__ import annotations

import torch

from deeplearning4j_torch.nn.conf.layers.base import BaseLayer, Layer


def _layer_param_pairs(net, params):
    for key, owner in net._param_owners().items():
        yield owner, params.get(key, {})


def penalty_value(net, params):
    """The reported L1/L2 penalty: one reduction per (l1, l2, dtype)
    coefficient group over the group's concatenated parameters, as the JAX
    package computes it; 0.0 (a float) when nothing is regularized. Layers
    with their own ``regularization`` (LayerNormalization's zero) keep
    it. Computed with no gradient."""
    groups: dict = {}
    reg = 0.0
    with torch.no_grad():
        for layer, sub in _layer_param_pairs(net, params):
            if not sub:
                continue
            meth = getattr(type(layer), "regularization", None)
            if meth is None or meth is Layer.regularization:
                continue
            if meth is not BaseLayer.regularization:
                reg = reg + layer.regularization(sub)
                continue
            for k, v in sub.items():
                c1, c2 = layer._coefficients(k)
                c1 = c1 if c1 > 0 else 0.0
                c2 = c2 if c2 > 0 else 0.0
                if c1 == 0.0 and c2 == 0.0:
                    continue
                groups.setdefault((c1, c2, v.dtype), []).append(
                    v.detach().reshape(-1))
        for (c1, c2, _), vs in groups.items():
            flat = vs[0] if len(vs) == 1 else torch.cat(vs)
            if c2 > 0:
                reg = reg + 0.5 * c2 * (flat * flat).sum()
            if c1 > 0:
                reg = reg + c1 * flat.abs().sum()
    return reg


def add_regularization_grads(net, params, grads):
    """``grads`` with each layer's closed-form penalty gradient added
    (mutates the freshly computed ``grads`` trees and returns them)."""
    for key, owner in net._param_owners().items():
        sub = params.get(key, {})
        for k, g in owner.regularization_grad(sub).items():
            grads[key][k] = grads[key][k] + g
    return grads
