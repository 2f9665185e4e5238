"""Weight initialisation schemes (port of ``deeplearning4j_tpu/nn/weights.py``):
every ``weight_init`` name of the JAX package and its ``Distribution``, with
the JAX formulas for each scheme's scale.

The draws come from a ``torch.Generator`` (on the CPU, so a seed gives the
same weights on every device), not from ``jax.random``: the schemes, fans
and scales are JAX's, the numbers are not. Parity tests load the
reference's weights instead of comparing draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from deeplearning4j_torch.utils.serde import register_serializable


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (hi - lo) + lo


@register_serializable
@dataclass(frozen=True)
class Distribution:
    """Config for ``weight_init="distribution"``: ``normal`` (mean, std) or
    ``uniform`` (lower, upper); any other kind draws the normal, as JAX's
    does."""

    kind: str = "normal"
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, gen, shape):
        if self.kind == "uniform":
            return _uniform(gen, shape, self.lower, self.upper)
        return self.mean + self.std * _normal(gen, shape)

    @staticmethod
    def normal(mean=0.0, std=1.0):
        return Distribution(kind="normal", mean=mean, std=std)

    @staticmethod
    def uniform(lower=-1.0, upper=1.0):
        return Distribution(kind="uniform", lower=lower, upper=upper)


#: scheme -> ("normal" | "uniform", scale(shape, fan_in, fan_out)): a normal
#: scheme draws N(0, 1)·scale, a uniform one U(-scale, scale)
SCHEMES = {
    "normal": ("normal", lambda s, fi, fo: 1.0 / math.sqrt(max(fi, 1.0))),
    "lecun_normal": ("normal",
                     lambda s, fi, fo: math.sqrt(1.0 / max(fi, 1.0))),
    "xavier": ("normal", lambda s, fi, fo: math.sqrt(2.0 / (fi + fo))),
    "xavier_fan_in": ("normal",
                      lambda s, fi, fo: 1.0 / math.sqrt(max(fi, 1.0))),
    "xavier_legacy": ("normal",
                      lambda s, fi, fo: 1.0 / math.sqrt(s[0] + s[-1])),
    "relu": ("normal", lambda s, fi, fo: math.sqrt(2.0 / max(fi, 1.0))),
    "xavier_uniform": ("uniform",
                       lambda s, fi, fo: math.sqrt(6.0 / (fi + fo))),
    "relu_uniform": ("uniform",
                     lambda s, fi, fo: math.sqrt(6.0 / max(fi, 1.0))),
    "uniform": ("uniform", lambda s, fi, fo: 1.0 / math.sqrt(max(fi, 1.0))),
    "sigmoid_uniform": ("uniform",
                        lambda s, fi, fo: 4.0 * math.sqrt(6.0 / (fi + fo))),
    "lecun_uniform": ("uniform",
                      lambda s, fi, fo: math.sqrt(3.0 / max(fi, 1.0))),
}


def init_weight(gen, shape, fan_in: float, fan_out: float,
                scheme: str = "xavier", distribution=None,
                dtype=torch.float32, device="cpu"):
    """A weight tensor of ``shape`` under ``scheme`` (JAX ``init_weight``'s
    formulas), drawn in f32 from ``gen`` and cast to ``dtype`` on
    ``device``."""
    scheme = str(scheme).lower()
    shape = tuple(int(s) for s in shape)
    if scheme == "zero":
        w = torch.zeros(shape)
    elif scheme == "ones":
        w = torch.ones(shape)
    elif scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY weight init requires square 2-D shape")
        w = torch.eye(shape[0])
    elif scheme == "distribution":
        w = (distribution or Distribution()).sample(gen, shape)
    elif scheme in SCHEMES:
        kind, scale = SCHEMES[scheme]
        s = scale(shape, fan_in, fan_out)
        w = _normal(gen, shape) * s if kind == "normal" else \
            _uniform(gen, shape, -s, s)
    else:
        raise ValueError(f"Unknown weight init scheme '{scheme}'")
    return w.to(device=device, dtype=dtype)
