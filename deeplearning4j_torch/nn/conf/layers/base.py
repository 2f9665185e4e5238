"""Layer base classes (port of ``deeplearning4j_tpu/nn/conf/layers/base.py``).

The contract stays functional, as in the JAX package:

- ``init_params(gen, dtype, device) -> dict[str, Tensor]`` and
  ``init_state(dtype, device)`` (batch-norm running statistics, loss
  centers);
- ``forward(params, state, x, *, mask, train, rng) -> (out, new_state)``;
- ``set_n_in(input_type)``/``output_type(input_type)``: shape inference
  over ``InputType`` at build time, and ``validate()``;
- ``regularization(params)`` (the L1/L2 penalty value) and
  ``regularization_grad(params)`` (its closed-form gradient per leaf, which
  the train step adds to the data-loss gradients, ``nn/regularization.py``).

The layers carry the JAX package's config fields (so its JSON loads field
for field). Fields left None are filled at build time from the global
configuration (``finalize(g)``, ``nn/conf/builders.py``), else from the
per-class defaults. ``rng`` is a ``[2]`` threefry key (``ops/random.py``);
inference (``train=False``) draws nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.weights import init_weight
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.ops.activations import Activation, get_activation


@dataclass
class Layer:
    """Base for all layer configs. ``dropout`` is the probability of
    dropping each input activation: inverted dropout on the layer INPUT
    (``apply_input_dropout``), as the JAX layers apply it."""

    name: Optional[str] = None
    dropout: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    #: True for layers that carry streaming state (KV pages or a position
    #: counter) through a serving carry
    STREAMS = False
    #: what array kind the layer consumes: ff | cnn | rnn | any (the
    #: builders insert a shape preprocessor where the input differs)
    INPUT_KIND = "any"

    def finalize(self, g=None) -> None:
        """Fill None fields from the global conf ``g``, else with the
        defaults the JAX package's builder gives them."""
        if self.dropout is None:
            self.dropout = (g.dropout if g is not None
                            and g.dropout is not None else 0.0)
        if self.gradient_normalization is None:
            self.gradient_normalization = (
                g.gradient_normalization if g is not None
                and g.gradient_normalization is not None else "none")
        if self.gradient_normalization_threshold is None:
            self.gradient_normalization_threshold = (
                g.gradient_normalization_threshold if g is not None
                and g.gradient_normalization_threshold is not None else 1.0)

    def set_n_in(self, input_type: InputType) -> None:
        """Infer nIn-like fields from the type of the layer's input."""

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def validate(self) -> None:
        """Build-time sanity: a layer with weights needs positive
        ``n_in``/``n_out`` (the JAX package's message)."""
        if not self.param_order():
            return
        for attr in ("n_in", "n_out"):
            v = getattr(self, attr, None)
            if isinstance(v, int) and v <= 0:
                label = self.name or type(self).__name__
                hint = (" (set an InputType on the builder, or pass "
                        f"{attr} explicitly)" if attr == "n_in" else "")
                raise ValueError(
                    f"Invalid configuration for layer '{label}': "
                    f"{attr} must be > 0, got {v}{hint}")

    def param_order(self) -> list[str]:
        """Parameter names in the flat-vector order (``params_flat``)."""
        return []

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device="cpu") -> dict:
        return {}

    def init_state(self, dtype=torch.float32, device="cpu") -> dict:
        """The layer's non-trainable state (empty for most layers)."""
        return {}

    def regularization(self, params: dict):
        """L1/L2 penalty value (none for a layer without weights)."""
        return 0.0

    def regularization_grad(self, params: dict) -> dict:
        """Closed-form penalty gradient per leaf (see BaseLayer)."""
        return {}

    def forward(self, params: dict, state: dict, x, *, mask=None,
                train: bool = False, rng=None):
        raise NotImplementedError

    def apply_input_dropout(self, x, *, train: bool, rng):
        """Inverted dropout on the input: keep each element with
        probability ``1 - dropout`` (``bernoulli(rng, keep, x.shape)``, the
        JAX package's draw bit for bit) and scale the kept ones by
        ``1/keep``. Only in training, and only with a key."""
        p = self.dropout or 0.0
        if train and p > 0.0 and rng is not None:
            keep = 1.0 - p
            m = random.bernoulli(rng, keep, x.shape)
            return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        return x

    def feed_forward_mask(self, mask):
        """How this layer transforms a time mask (identity by default)."""
        return mask


@dataclass
class BaseLayer(Layer):
    """Layers with weights: activation, weight and bias init, the L1/L2
    regularization fields and the per-layer learning rates."""

    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[object] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    # per-layer learning-rate overrides; None takes the updater's rate
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None

    DEFAULT_ACTIVATION = "sigmoid"

    def finalize(self, g=None) -> None:
        super().finalize(g)
        if self.activation is None:
            self.activation = ((g.activation if g is not None else None)
                               or self.DEFAULT_ACTIVATION)
        if self.weight_init is None:
            self.weight_init = ((g.weight_init if g is not None else None)
                                or "xavier")
        if self.dist is None and g is not None:
            self.dist = g.dist
        if self.bias_init is None:
            self.bias_init = (g.bias_init if g is not None
                              and g.bias_init is not None else 0.0)
        for f in ("l1", "l2", "l1_bias", "l2_bias"):
            if getattr(self, f) is None:
                gv = getattr(g, f, None) if g is not None else None
                setattr(self, f, gv if gv is not None else 0.0)

    def act(self) -> Activation:
        return get_activation(self.activation or self.DEFAULT_ACTIVATION)

    def _init_w(self, gen, shape, fan_in, fan_out, dtype, device):
        """A weight under ``weight_init``/``dist`` (``nn/weights.py``).
        ``gen=None`` draws nothing: zeros of the shape, for weights about
        to be loaded."""
        if gen is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return init_weight(gen, shape, fan_in, fan_out,
                           self.weight_init or "xavier", self.dist, dtype,
                           device)

    def _bias(self, n, dtype, device):
        return torch.full((n,), float(self.bias_init or 0.0), dtype=dtype,
                          device=device)

    def bias_param_names(self) -> frozenset:
        """Params that take l1_bias/l2_bias (and bias_learning_rate)
        instead of l1/l2."""
        return frozenset({"b"})

    def _coefficients(self, k):
        biases = self.bias_param_names()
        if k in biases:
            return self.l1_bias or 0.0, self.l2_bias or 0.0
        return self.l1 or 0.0, self.l2 or 0.0

    def regularization(self, params: dict):
        reg = 0.0
        for k, v in params.items():
            l1, l2 = self._coefficients(k)
            if l2 > 0:
                reg = reg + 0.5 * l2 * (v * v).sum()
            if l1 > 0:
                reg = reg + l1 * v.abs().sum()
        return reg

    def regularization_grad(self, params: dict) -> dict:
        """``l2·W + l1·sign(W)`` per leaf with a coefficient, the gradient
        of ``regularization`` in closed form."""
        out = {}
        for k, v in params.items():
            c1, c2 = self._coefficients(k)
            g = None
            if c2 > 0:
                g = c2 * v
            if c1 > 0:
                g = (0 if g is None else g) + c1 * torch.sign(v)
            if g is not None:
                out[k] = g
        return out


@dataclass
class FeedForwardLayer(BaseLayer):
    """Dense-style layers with explicit nIn/nOut."""

    n_in: int = 0
    n_out: int = 0

    INPUT_KIND = "ff"

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.recurrent(self.n_out,
                                       input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)
