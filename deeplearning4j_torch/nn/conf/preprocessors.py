"""Input preprocessors (port of ``deeplearning4j_tpu/nn/conf/preprocessors.py``):
the shape adapters the builders insert between layer kinds, the per-batch
normalizers, Bernoulli sampling and the composable chain. Layouts are NHWC
and ``[B, T, F]``. Only the forward is written: autograd derives the
backward reshape, and the normalizers detach their batch statistics (the
JAX package's ``stop_gradient``), so their backward passes the gradient
through unchanged."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.utils.serde import register_serializable

_EPS = 1e-5  # added to the standard deviation of the variance normalizers

#: the word a preprocessor's key is folded from its layer's
_PREPROCESSOR_FOLD = 0x9E37


def preprocessor_key(rng):
    """The key a stochastic preprocessor draws from, derived from the key
    of the layer behind it (``fold_in(rng, 0x9E37)``, the JAX package's
    derivation), so the preprocessor and the layer's dropout never share
    uniforms. None stays None."""
    return None if rng is None else random.fold_in(rng, _PREPROCESSOR_FOLD)


@dataclass
class InputPreProcessor:
    #: True where ``forward`` draws from its key in training
    DRAWS = False

    def forward(self, x, rng=None):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        return mask


@register_serializable
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """``[B, H, W, C] -> [B, H*W*C]``, row-major over (h, w, c)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def forward(self, x, rng=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.flat_size())


@register_serializable
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """``[B, H*W*C] -> [B, H, W, C]``."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def forward(self, x, rng=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_serializable
@dataclass
class ZeroMeanPrePreProcessor(InputPreProcessor):
    """Subtract the per-column batch mean (a constant to the backward)."""

    def forward(self, x, rng=None):
        return x - x.mean(dim=0, keepdim=True).detach()

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


def _unit_std(x):
    """The per-column sample standard deviation (``ddof=1``) plus eps, as
    a constant to the backward."""
    return (x.std(dim=0, keepdim=True, correction=1) + _EPS).detach()


@register_serializable
@dataclass
class UnitVarianceProcessor(InputPreProcessor):
    """Divide by the per-column batch standard deviation plus eps; a
    single example passes unchanged (its ``ddof=1`` std is undefined)."""

    def forward(self, x, rng=None):
        if x.shape[0] < 2:
            return x
        return x / _unit_std(x)

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_serializable
@dataclass
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    """Standardize each column over the batch."""

    def forward(self, x, rng=None):
        x = x - x.mean(dim=0, keepdim=True).detach()
        if x.shape[0] < 2:
            return x
        return x / _unit_std(x)

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_serializable
@dataclass
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Sample each activation as a Bernoulli probability (``uniform <
    x`` in x's dtype, ``jax.random.bernoulli``'s draw bit for bit), with a
    straight-through backward. Training passes the step's derived key;
    without one the draw uses ``PRNGKey(seed)``."""

    seed: int = 0

    DRAWS = True

    def forward(self, x, rng=None):
        key = random.PRNGKey(self.seed, device=x.device) if rng is None \
            else rng
        sample = (random.uniform(key, x.shape, x.dtype) < x).to(x.dtype)
        return x + (sample - x).detach()

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_serializable
@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """The processors in order, processor i keyed by ``fold_in(rng,
    i)``."""

    processors: list = field(default_factory=list)

    @property
    def DRAWS(self):  # noqa: N802 (the class attribute's name)
        return any(p.DRAWS for p in self.processors)

    def forward(self, x, rng=None):
        for i, p in enumerate(self.processors):
            x = p.forward(x, rng=None if rng is None
                          else random.fold_in(rng, i))
        return x

    def output_type(self, input_type: InputType) -> InputType:
        for p in self.processors:
            input_type = p.output_type(input_type)
        return input_type

    def feed_forward_mask(self, mask):
        for p in self.processors:
            mask = p.feed_forward_mask(mask)
        return mask


@register_serializable
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """``[B, T, F] -> [B*T, F]``."""

    def forward(self, x, rng=None):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)


@register_serializable
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """``[B, F] -> [B, 1, F]``."""

    def forward(self, x, rng=None):
        return x[:, None, :]

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size())


@register_serializable
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """``[B, H, W, C] -> [B, H*W, C]``: each pixel a time step."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def forward(self, x, rng=None):
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.channels,
                                   input_type.height * input_type.width)


@register_serializable
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """``[B, T, F] -> [B, H, W, C]`` with T = H*W and F = C."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def forward(self, x, rng=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


def default_preprocessor(input_type: InputType, layer):
    """The preprocessor the builders insert before ``layer`` for an input
    of ``input_type`` (the JAX package's choice), or None."""
    kind_in = input_type.kind
    expects = getattr(layer, "INPUT_KIND", "any")
    if expects == "cnn":
        if kind_in in ("convolutional_flat", "feed_forward"):
            if input_type.height and input_type.width:
                return FeedForwardToCnnPreProcessor(
                    height=input_type.height, width=input_type.width,
                    channels=input_type.channels)
            raise ValueError(
                f"Cannot feed {kind_in} input into CNN layer {layer} "
                "without height/width info; use "
                "InputType.convolutional_flat(h, w, c)")
        return None
    if expects == "rnn":
        if kind_in == "convolutional":
            return CnnToRnnPreProcessor(height=input_type.height,
                                        width=input_type.width,
                                        channels=input_type.channels)
        return None
    if expects == "ff" and kind_in == "convolutional":
        return CnnToFeedForwardPreProcessor(height=input_type.height,
                                            width=input_type.width,
                                            channels=input_type.channels)
    return None
