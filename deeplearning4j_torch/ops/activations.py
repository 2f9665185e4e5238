"""Activation functions (port of ``deeplearning4j_tpu/ops/activations.py``).

Only the activations the TransformerLM slice needs are ported: identity,
softmax (over the last axis) and gelu. ``jax.nn.gelu`` defaults to the tanh
approximation, so the port's gelu is ``F.gelu(x, approximate="tanh")``; the
exact erf form would be a parity bug.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_REGISTRY: dict[str, "Activation"] = {}


class Activation:
    """A named activation function. Callable."""

    def __init__(self, name: str, fn):
        self.name = name
        self._fn = fn

    def __call__(self, x):
        return self._fn(x)


def _register(name: str, fn) -> Activation:
    act = Activation(name, fn)
    _REGISTRY[name] = act
    return act


def get_activation(name) -> Activation:
    """Resolve an activation by name (case-insensitive) or pass through an
    Activation."""
    if isinstance(name, Activation):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation '{name}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


IDENTITY = _register("identity", lambda x: x)
SOFTMAX = _register("softmax", lambda x: torch.softmax(x, dim=-1))
GELU = _register("gelu", lambda x: F.gelu(x, approximate="tanh"))
