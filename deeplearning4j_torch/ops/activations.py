"""Activation functions (port of ``deeplearning4j_tpu/ops/activations.py``).

Every activation of the JAX package's registry, under its names. Each is an
elementwise torch function except ``softmax``, which normalises over the
last (feature) axis. The forms follow ``jax.nn``:

- ``gelu`` is ``jax.nn.gelu``'s default, the tanh approximation
  (``F.gelu(x, approximate="tanh")``); the exact erf form would be a
  parity bug;
- ``softplus`` is ``jax.nn.softplus``, ``logaddexp(x, 0)`` (torch's
  ``F.softplus`` returns ``x`` past a threshold);
- ``hardsigmoid`` is the package's ``clip(0.2·x + 0.5, 0, 1)``, not torch's
  ``x/6 + 1/2``;
- ``leakyrelu`` has slope 0.01, ``rationaltanh`` is ``1.7159·tanh(2x/3)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_REGISTRY: dict[str, "Activation"] = {}


class Activation:
    """A named activation function. Callable; serialises to its name."""

    def __init__(self, name: str, fn):
        self.name = name
        self._fn = fn

    def __call__(self, x):
        return self._fn(x)

    def __repr__(self):  # pragma: no cover
        return f"Activation({self.name})"

    def __eq__(self, other):
        return isinstance(other, Activation) and other.name == self.name

    def __hash__(self):
        return hash(self.name)


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


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


IDENTITY = _register("identity", lambda x: x)
LINEAR = _register("linear", lambda x: x)
RELU = _register("relu", torch.relu)
RELU6 = _register("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
LEAKYRELU = _register("leakyrelu", lambda x: F.leaky_relu(x, 0.01))
TANH = _register("tanh", torch.tanh)
SIGMOID = _register("sigmoid", torch.sigmoid)
SOFTMAX = _register("softmax", lambda x: torch.softmax(x, dim=-1))
SOFTPLUS = _register("softplus", _softplus)
SOFTSIGN = _register("softsign", F.softsign)
ELU = _register("elu", F.elu)
SELU = _register("selu", F.selu)
GELU = _register("gelu", lambda x: F.gelu(x, approximate="tanh"))
SILU = _register("silu", F.silu)
SWISH = _register("swish", F.silu)
CUBE = _register("cube", lambda x: x ** 3)
HARDTANH = _register("hardtanh", lambda x: torch.clamp(x, -1.0, 1.0))
HARDSIGMOID = _register("hardsigmoid",
                        lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0))
RATIONALTANH = _register("rationaltanh",
                         lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0))
RECTIFIEDTANH = _register("rectifiedtanh",
                          lambda x: torch.clamp(torch.tanh(x), min=0.0))
