"""Global pooling (port of ``nn/conf/layers/pooling.py``): over time
(``[B, T, F] -> [B, F]``, masked steps left out) or space (``[B, H, W, C]
-> [B, C]``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import Layer
from deeplearning4j_torch.utils.serde import register_serializable


class PoolingType:
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


@register_serializable
@dataclass
class GlobalPoolingLayer(Layer):
    """Max, avg, sum or pnorm over every axis but batch and features. Under
    a time mask, max fills masked steps with -inf and avg/sum leave them
    out of numerator and denominator. Max uses ``amax``, whose backward
    shares the gradient among tied maxima as JAX's does."""

    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "convolutional":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def feed_forward_mask(self, mask):
        return None  # the pooled axis is gone, and the mask with it

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        if x.dim() == 3:
            axes = (1,)
        elif x.dim() == 4:
            axes = (1, 2)
        else:
            raise ValueError(f"GlobalPooling expects 3-D or 4-D input, got "
                             f"{tuple(x.shape)}")
        pt = self.pooling_type.lower()
        p = float(self.pnorm)
        if mask is not None and x.dim() == 3:
            m = mask.to(x.dtype)[:, :, None]
            if pt == "max":
                out = torch.where(m > 0, x, float("-inf")).amax(dim=1)
            elif pt == "sum":
                out = (x * m).sum(dim=1)
            elif pt == "avg":
                out = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
            elif pt == "pnorm":
                out = ((x.abs() * m) ** p).sum(dim=1) ** (1.0 / p)
            else:
                raise ValueError(f"Unknown pooling type "
                                 f"'{self.pooling_type}'")
            return out, state
        if pt == "max":
            out = x.amax(dim=axes)
        elif pt == "sum":
            out = x.sum(dim=axes)
        elif pt == "avg":
            out = x.mean(dim=axes)
        elif pt == "pnorm":
            out = (x.abs() ** p).sum(dim=axes) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type '{self.pooling_type}'")
        return out, state
