"""Updaters (optimizers) and learning-rate schedules (port of
``deeplearning4j_tpu/nn/updater.py``).

Parameters, gradients and updater state are plain trees
``{vertex: {param: Tensor}}``, as in the JAX package; each slot of the
state (Adam's ``m`` and ``v``, ...) is such a tree. ``step`` returns the
STEP to subtract, ``params_new = params - step``, and the new state. Each
updater keeps the JAX formulas, slot names and order of operations.

The scalars of an update (the scheduled learning rate, Adam's ``t =
iteration + 1`` and bias correction) are f32 in JAX; here they are computed
on the host as numpy f32 scalars, so a step costs no device sync and no
host-to-device copy. Per-leaf learning rates take a scalar multiplier or a
tree of them (``lr_mult``), as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch.utils.serde import register_serializable

_f32 = np.float32


def _tmap(f, *trees):
    """Apply ``f`` leaf by leaf over trees shaped like the first."""
    first = trees[0]
    return {v: {k: f(*(t[v][k] for t in trees)) for k in first[v]}
            for v in first}


def _tree_zeros(params):
    return _tmap(torch.zeros_like, params)


@register_serializable
@dataclass
class LearningRateSchedule:
    """lr(iteration). policy: none|exponential|inverse|poly|sigmoid|step|
    schedule."""

    policy: str = "none"
    decay_rate: float = 0.0
    power: float = 1.0
    steps: float = 1.0
    max_iterations: int = 10000
    schedule: Optional[dict] = None  # {iteration(str|int): lr}

    def __call__(self, base_lr, iteration):
        it = _f32(iteration)
        p = self.policy
        if p == "none":
            return base_lr
        lr0, rate = _f32(base_lr), _f32(self.decay_rate)
        if p == "exponential":
            return lr0 * rate ** it
        if p == "inverse":
            return lr0 / (_f32(1.0) + rate * it) ** _f32(self.power)
        if p == "poly":
            frac = np.clip(it / _f32(self.max_iterations), _f32(0.0),
                           _f32(1.0))
            return lr0 * (_f32(1.0) - frac) ** _f32(self.power)
        if p == "sigmoid":
            return lr0 / (_f32(1.0) + np.exp(-rate * (it - _f32(self.steps))))
        if p == "step":
            return lr0 * rate ** np.floor(it / _f32(self.steps))
        if p == "schedule":
            # piecewise constant: keys are iteration thresholds
            lr = base_lr
            for k in sorted(self.schedule or {}, key=lambda s: int(s)):
                if it >= int(k):
                    lr = self.schedule[k]
            return _f32(lr)
        raise ValueError(f"Unknown LR policy '{p}'")


@dataclass
class Updater:
    """Base updater config. State: dict of trees keyed by slot name."""

    learning_rate: float = 0.1
    lr_schedule: LearningRateSchedule = field(
        default_factory=LearningRateSchedule)

    def init(self, params):
        return {}

    def lr(self, iteration):
        return self.lr_schedule(self.learning_rate, iteration)

    def scale_lr(self, factor: float) -> float:
        """Rescale the base learning rate in place (the whole schedule
        shifts with it) and return the new value."""
        if not factor > 0:
            raise ValueError(f"scale_lr factor must be > 0, got {factor}")
        self.learning_rate = self.learning_rate * factor
        return self.learning_rate

    def lr_tree(self, grads, iteration, lr_mult):
        """Per-leaf effective learning rate, schedule(base_lr) * multiplier,
        as host floats."""
        lr = self.lr(iteration)
        if isinstance(lr_mult, dict):
            return {v: {k: float(lr * m) for k, m in p.items()}
                    for v, p in lr_mult.items()}
        return _tmap(lambda g: float(lr * lr_mult), grads)

    def step(self, grads, state, iteration, lr_mult=1.0):
        raise NotImplementedError


@register_serializable
@dataclass
class Sgd(Updater):
    def step(self, grads, state, iteration, lr_mult=1.0):
        lrs = self.lr_tree(grads, iteration, lr_mult)
        return _tmap(lambda g, lr: lr * g, grads, lrs), state


@register_serializable
@dataclass
class NoOp(Updater):
    def step(self, grads, state, iteration, lr_mult=1.0):
        return _tmap(torch.zeros_like, grads), state


@register_serializable
@dataclass
class Nesterovs(Updater):
    momentum: float = 0.9

    def init(self, params):
        return {"v": _tree_zeros(params)}

    def step(self, grads, state, iteration, lr_mult=1.0):
        lrs = self.lr_tree(grads, iteration, lr_mult)
        mu = self.momentum
        v_old = state["v"]
        v_new = _tmap(lambda v, g, lr: mu * v - lr * g, v_old, grads, lrs)
        # param += -mu*v_old + (1+mu)*v_new  (nd4j NesterovsUpdater form)
        steps = _tmap(lambda vo, vn: mu * vo - (1.0 + mu) * vn, v_old, v_new)
        return steps, {"v": v_new}


def _t(iteration):
    """``t = iteration + 1`` as f32, as the JAX step computes it."""
    return _f32(iteration) + _f32(1.0)


@register_serializable
@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params)}

    def step(self, grads, state, iteration, lr_mult=1.0):
        lrs = self.lr_tree(grads, iteration, lr_mult)
        t = _t(iteration)
        b1, b2 = self.beta1, self.beta2
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = _tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
        bias_corr = np.sqrt(_f32(1.0) - _f32(b2) ** t) \
            / (_f32(1.0) - _f32(b1) ** t)
        steps = _tmap(
            lambda m, v, lr: float(_f32(lr) * bias_corr) * m
            / (torch.sqrt(v) + self.epsilon), m, v, lrs)
        return steps, {"m": m, "v": v}


@register_serializable
@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _tree_zeros(params), "u": _tree_zeros(params)}

    def step(self, grads, state, iteration, lr_mult=1.0):
        lrs = self.lr_tree(grads, iteration, lr_mult)
        t = _t(iteration)
        b1, b2 = self.beta1, self.beta2
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        u = _tmap(lambda u, g: torch.maximum(b2 * u, torch.abs(g)),
                  state["u"], grads)
        corr = _f32(1.0) / (_f32(1.0) - _f32(b1) ** t)
        steps = _tmap(lambda m, u, lr: float(_f32(lr) * corr) * m
                      / (u + self.epsilon), m, u, lrs)
        return steps, {"m": m, "u": u}


@register_serializable
@dataclass
class Nadam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params)}

    def step(self, grads, state, iteration, lr_mult=1.0):
        lrs = self.lr_tree(grads, iteration, lr_mult)
        t = _t(iteration)
        b1, b2 = self.beta1, self.beta2
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = _tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
        c2 = float(_f32(1.0) - _f32(b2) ** t)
        c1n = float(_f32(1.0) - _f32(b1) ** (t + _f32(1.0)))
        c1 = float(_f32(1.0) - _f32(b1) ** t)
        steps = _tmap(
            lambda m, v, g, lr: lr / (torch.sqrt(v / c2) + self.epsilon)
            * (b1 * m / c1n + (1 - b1) * g / c1),
            m, v, grads, lrs)
        return steps, {"m": m, "v": v}


@register_serializable
@dataclass
class AdaGrad(Updater):
    epsilon: float = 1e-6

    def init(self, params):
        return {"h": _tree_zeros(params)}

    def step(self, grads, state, iteration, lr_mult=1.0):
        lrs = self.lr_tree(grads, iteration, lr_mult)
        h = _tmap(lambda h, g: h + g * g, state["h"], grads)
        steps = _tmap(lambda h, g, lr: lr * g / (torch.sqrt(h) + self.epsilon),
                      h, grads, lrs)
        return steps, {"h": h}


@register_serializable
@dataclass
class RmsProp(Updater):
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return {"h": _tree_zeros(params)}

    def step(self, grads, state, iteration, lr_mult=1.0):
        lrs = self.lr_tree(grads, iteration, lr_mult)
        d = self.rms_decay
        h = _tmap(lambda h, g: d * h + (1 - d) * g * g, state["h"], grads)
        steps = _tmap(lambda h, g, lr: lr * g / torch.sqrt(h + self.epsilon),
                      h, grads, lrs)
        return steps, {"h": h}


@register_serializable
@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init(self, params):
        return {"eg": _tree_zeros(params), "ex": _tree_zeros(params)}

    def step(self, grads, state, iteration, lr_mult=1.0):
        # AdaDelta has no learning rate (reference: nd4j AdaDeltaUpdater);
        # lr_mult is intentionally ignored.
        rho, eps = self.rho, self.epsilon
        eg = _tmap(lambda e, g: rho * e + (1 - rho) * g * g, state["eg"],
                   grads)
        dx = _tmap(lambda g, e, x: g * torch.sqrt(x + eps)
                   / torch.sqrt(e + eps), grads, eg, state["ex"])
        ex = _tmap(lambda x, d: rho * x + (1 - rho) * d * d, state["ex"], dx)
        return dx, {"eg": eg, "ex": ex}

