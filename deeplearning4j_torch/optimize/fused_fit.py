"""The training step core (port of ``build_step_core`` in
``deeplearning4j_tpu/optimize/fused_fit.py``, unguarded).

One functional SGD step over a net's ``_loss`` contract: the gradient of the
loss with respect to the parameter leaves, the updater, then ``params -
steps``. The parameters stay plain tensors, as ``jax.value_and_grad(params)``
leaves them: the step marks detached copies of the leaves ``requires_grad``,
and builds the new parameters under ``torch.no_grad()``.

Not ported yet: the fused K-step driver, the numerical-health guard (both
ROADMAP §A5), regularization, gradient normalization, dropout and per-layer
learning rates (ROADMAP §A6). A configuration that asks for any of the last
four raises.
"""

from __future__ import annotations

import torch

#: layer fields that act in training and are not ported: regularization,
#: gradient normalization, input dropout and per-layer learning rates. Each
#: is refused when set away from its default (None, 0 or "none").
_UNPORTED_FIELDS = ("l1", "l2", "l1_bias", "l2_bias", "weight_decay",
                    "gradient_normalization", "dropout", "learning_rate",
                    "bias_learning_rate")


def _check_conf(net):
    for name, v in net.conf.vertices.items():
        layer = getattr(v, "layer", None)
        for f in _UNPORTED_FIELDS:
            value = getattr(layer, f, None)
            if value not in (None, 0, 0.0, "none"):
                raise NotImplementedError(
                    f"vertex '{name}' sets {f}={value!r}: regularization, "
                    "gradient normalization, dropout and per-layer learning "
                    "rates are not ported yet (ROADMAP §A6)")


def value_and_grad(net, params, state, x, y, input_mask=None,
                   label_mask=None):
    """``(loss, grads)`` of ``net._loss`` at ``params``; ``grads`` has the
    tree shape of ``params`` and ``loss`` is a detached 0-d tensor."""
    leaves = {v: {k: t.detach().requires_grad_(True) for k, t in p.items()}
              for v, p in params.items()}
    flat = [t for p in leaves.values() for t in p.values()]
    with torch.enable_grad():
        loss = net._loss(leaves, state, x, y, input_mask, label_mask)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(gs)
    grads = {}
    for v, p in leaves.items():
        grads[v] = {}
        for k, t in p.items():
            g = next(it)
            grads[v][k] = torch.zeros_like(t) if g is None else g
    return loss.detach(), grads


def build_step_core(net):
    """``core(params, opt_state, state, iteration, x, y, input_mask,
    label_mask) -> (new_params, new_opt, state, loss)``: one step of
    ``net.conf.updater``."""
    _check_conf(net)
    updater = net.conf.updater

    def core(params, opt_state, state, iteration, x, y, input_mask,
             label_mask):
        loss, grads = value_and_grad(net, params, state, x, y, input_mask,
                                     label_mask)
        with torch.no_grad():
            steps, opt_state2 = updater.step(grads, opt_state, iteration)
            new_params = {v: {k: t - steps[v][k] for k, t in p.items()}
                          for v, p in params.items()}
        return new_params, opt_state2, state, loss

    return core
