"""Batch optimizers beyond SGD (port of
``deeplearning4j_tpu/optimize/solvers.py``): the termination conditions,
the backtracking line search, line gradient descent, nonlinear conjugate
gradient (Polak-Ribière, restarting), L-BFGS (memory 10) and the
``Solver`` facade that picks one from the configuration's
``optimization_algo``.

The net's loss (``_loss`` in inference mode, plus the closed-form L1/L2
gradient the train step adds) is a function of one flat parameter vector
on the net's device, in the flat order of ``utils/pytree.py`` (the JAX
package uses ``ravel_pytree``'s sorted order; the arithmetic does not
depend on the order but for rounding). Each optimizer is host control flow
over device vectors: the line search's trial count depends on the data, so
every dot product and loss is read back to the host, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_torch.nn.regularization import add_regularization_grads
from deeplearning4j_torch.optimize.fused_fit import value_and_grad
from deeplearning4j_torch.utils.pytree import flat_slots


# ----------------------------------------------------------------- terminations
class TerminationCondition:
    def terminate(self, cost: float, old_cost: float, other=None) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    """``2·|old - new| <= tolerance · (|old| + |new| + eps)``."""

    def __init__(self, eps: float = 1e-10, tolerance: float = 1e-5):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, cost, old_cost, other=None):
        return 2.0 * abs(old_cost - cost) <= self.tolerance * (
            abs(old_cost) + abs(cost) + self.eps)


class Norm2Termination(TerminationCondition):
    """The gradient's L2 norm below a threshold."""

    def __init__(self, gradient_norm_threshold: float = 1e-8):
        self.threshold = gradient_norm_threshold

    def terminate(self, cost, old_cost, other=None):
        return other is not None and float(other) < self.threshold


class ZeroDirection(TerminationCondition):
    def terminate(self, cost, old_cost, other=None):
        return other is not None and float(other) == 0.0


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


# ------------------------------------------------------------------ line search
class BackTrackLineSearch:
    """Backtracking line search under Armijo's sufficient decrease (relax
    constant ``alf`` 1e-4, the step contracted by ``contraction`` up to
    ``max_iterations`` times, the first step capped at ``step_max /
    |direction|``)."""

    def __init__(self, loss_fn: Callable, max_iterations: int = 5,
                 step_max: float = 100.0, alf: float = 1e-4,
                 contraction: float = 0.5):
        self.loss_fn = loss_fn
        self.max_iterations = max_iterations
        self.step_max = step_max
        self.alf = alf
        self.contraction = contraction

    def optimize(self, x, f0: float, g, direction,
                 initial_step: float = 1.0) -> float:
        """The accepted step size along ``direction`` from ``x`` (0.0 when
        ``direction`` does not descend)."""
        slope = _dot(g, direction)
        if slope >= 0:
            return 0.0
        dnorm = float(torch.linalg.vector_norm(direction))
        step = min(initial_step, self.step_max / max(dnorm, 1e-12))
        for _ in range(self.max_iterations):
            f_new = float(self.loss_fn(x + step * direction))
            if f_new <= f0 + self.alf * step * slope:
                return step
            step *= self.contraction
        return step


# ------------------------------------------------------------------- optimizers
class BaseOptimizer:
    """The flat view of a net's loss and gradient, and the termination
    checks. ``history`` records each accepted iteration's ``(loss, step)``
    and ``reason`` why the run stopped (``"terminated"``, ``"zero_step"``
    or ``"max_iterations"``), for comparing runs iteration by
    iteration."""

    def __init__(self, max_iterations: int = 10,
                 terminations: Optional[list] = None,
                 line_search_iterations: int = 5):
        self.max_iterations = max_iterations
        self.terminations = terminations or [EpsTermination()]
        self.line_search_iterations = line_search_iterations
        self.history: list = []
        self.reason: Optional[str] = None

    def _setup(self, net, x, y):
        params0 = net.params
        slots = flat_slots(params0, net._param_owners())
        shapes = [(v, p, params0[v][p].shape) for v, p in slots]
        xs, ys, _, _ = net._batch(x, y, None, None)

        def ravel(tree):
            return torch.cat([tree[v][p].reshape(-1) for v, p, _ in shapes])

        def unravel(flat):
            out = {v: dict(p) for v, p in params0.items()}
            off = 0
            for v, p, shape in shapes:
                n = shape.numel()
                out[v][p] = flat[off:off + n].reshape(shape)
                off += n
            return out

        def value(flat):
            with torch.no_grad():
                loss, _ = net._loss(unravel(flat), net.state, xs, ys, None,
                                    None, train=False, rng=None)
            return loss

        def vg(flat):
            params = unravel(flat)
            loss, grads = value_and_grad(net, params, net.state, xs, ys)
            with torch.no_grad():
                grads = add_regularization_grads(net, params, grads)
            return loss, ravel(grads)

        with torch.no_grad():
            flat0 = ravel(params0)
        self.history = []
        self.reason = "max_iterations"
        return flat0, unravel, value, vg

    def _terminated(self, loss, old, g) -> bool:
        if any(t.terminate(float(loss), old, torch.linalg.vector_norm(g))
               for t in self.terminations):
            self.reason = "terminated"
            return True
        return False

    def optimize(self, net, x, y) -> float:
        raise NotImplementedError

    def _finish(self, net, flat, unravel, loss):
        net.params = {v: {k: t.clone() for k, t in p.items()}
                      for v, p in unravel(flat).items()}
        net.score_value = float(loss)
        return float(loss)


class LineGradientDescent(BaseOptimizer):
    """Steepest descent with the backtracking line search."""

    def optimize(self, net, x, y) -> float:
        flat, unravel, value, vg = self._setup(net, x, y)
        loss, g = vg(flat)
        for _ in range(self.max_iterations):
            direction = -g
            ls = BackTrackLineSearch(value, self.line_search_iterations)
            step = ls.optimize(flat, float(loss), g, direction)
            if step == 0.0:
                self.reason = "zero_step"
                break
            flat = flat + step * direction
            old = float(loss)
            loss, g = vg(flat)
            self.history.append((float(loss), step))
            if self._terminated(loss, old, g):
                break
        return self._finish(net, flat, unravel, loss)


class ConjugateGradient(BaseOptimizer):
    """Nonlinear conjugate gradient, Polak-Ribière with beta clamped at 0
    (an automatic restart), and a steepest-descent restart when the line
    search finds no step."""

    def optimize(self, net, x, y) -> float:
        flat, unravel, value, vg = self._setup(net, x, y)
        loss, g = vg(flat)
        direction = -g
        for _ in range(self.max_iterations):
            ls = BackTrackLineSearch(value, self.line_search_iterations)
            step = ls.optimize(flat, float(loss), g, direction)
            if step == 0.0:
                direction = -g  # restart
                step = ls.optimize(flat, float(loss), g, direction)
                if step == 0.0:
                    self.reason = "zero_step"
                    break
            flat = flat + step * direction
            old = float(loss)
            loss, g_new = vg(flat)
            self.history.append((float(loss), step))
            beta = _dot(g_new, g_new - g) / max(_dot(g, g), 1e-12)
            beta = max(0.0, beta)
            direction = -g_new + beta * direction
            g = g_new
            if self._terminated(loss, old, g):
                break
        return self._finish(net, flat, unravel, loss)


class LBFGS(BaseOptimizer):
    """Limited-memory BFGS by the two-loop recursion, ``memory`` pairs."""

    def __init__(self, max_iterations: int = 10, memory: int = 10, **kw):
        super().__init__(max_iterations=max_iterations, **kw)
        self.memory = memory

    def optimize(self, net, x, y) -> float:
        flat, unravel, value, vg = self._setup(net, x, y)
        loss, g = vg(flat)
        s_hist: list = []
        y_hist: list = []
        for _ in range(self.max_iterations):
            q = g
            alphas = []
            for s, yv in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / max(_dot(yv, s), 1e-12)
                a = rho * _dot(s, q)
                alphas.append((a, rho, s, yv))
                q = q - a * yv
            if y_hist:
                gamma = _dot(s_hist[-1], y_hist[-1]) / max(
                    _dot(y_hist[-1], y_hist[-1]), 1e-12)
                q = gamma * q
            for a, rho, s, yv in reversed(alphas):
                b = rho * _dot(yv, q)
                q = q + (a - b) * s
            direction = -q
            ls = BackTrackLineSearch(value, self.line_search_iterations)
            step = ls.optimize(flat, float(loss), g, direction)
            if step == 0.0:
                self.reason = "zero_step"
                break
            new_flat = flat + step * direction
            old = float(loss)
            new_loss, new_g = vg(new_flat)
            self.history.append((float(new_loss), step))
            s_hist.append(new_flat - flat)
            y_hist.append(new_g - g)
            if len(s_hist) > self.memory:
                s_hist.pop(0)
                y_hist.pop(0)
            flat, loss, g = new_flat, new_loss, new_g
            if self._terminated(loss, old, g):
                break
        return self._finish(net, flat, unravel, loss)


_SOLVERS = {
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


class Solver:
    """The optimizer named by ``algorithm`` or the net configuration's
    ``optimization_algo`` (``"stochastic_gradient_descent"``: one
    ``do_step``). It runs where the net lives: the device its ``init``
    resolved (CUDA unless the caller asked for the host)."""

    def __init__(self, net, algorithm: Optional[str] = None,
                 max_iterations: int = 10, **kw):
        algo = (algorithm or getattr(net.conf, "optimization_algo",
                                     "stochastic_gradient_descent")).lower()
        if algo == "stochastic_gradient_descent":
            self.optimizer = None
        elif algo in _SOLVERS:
            self.optimizer = _SOLVERS[algo](max_iterations=max_iterations,
                                            **kw)
        else:
            raise ValueError(f"Unknown optimization algorithm '{algo}'")
        self.net = net

    def optimize(self, x, y) -> float:
        if self.optimizer is None:
            loss, _ = self.net.do_step(x, y)
            return loss
        return self.optimizer.optimize(self.net, x, y)
