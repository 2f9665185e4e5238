"""Convolution, pooling, padding and upsampling layers (port of
``deeplearning4j_tpu/nn/conf/layers/convolution.py``).

Activations are NHWC and kernels HWIO, in the params and in the zip, as in
the JAX package. A convolution hands PyTorch the views
``x.permute(0, 3, 1, 2)`` (channels-last strides, which cuDNN takes without
a copy) and ``W.permute(3, 2, 0, 1)``, and permutes the result back.

Precision and determinism are the layers' own: every convolution, forward
and backward, runs under ``torch.backends.cudnn.flags(allow_tf32=False,
deterministic=True, benchmark=False)`` (``_Convolution``), whatever the
process-wide flags say, so an f32 convolution on the card is an f32
convolution (PyTorch's cuDNN default is TF32) and a training step is
repeatable bit for bit.

``convolution_mode="same"`` is XLA's SAME, padded explicitly (lo = total //
2, hi = total - lo, which ``padding="same"`` in torch cannot express at
stride > 1). Pooling follows ``lax.reduce_window``: max pads with -inf, avg
divides by the count of real elements in each window, pnorm is
``(sum |x|^p)^(1/p)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import BaseLayer, Layer
from deeplearning4j_torch.utils.serde import register_serializable


def _pair(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv_out_size(size: int, k: int, s: int, p: int, mode: str) -> int:
    """Output length of a window of ``k`` at stride ``s`` over ``size``
    with padding ``p`` under ``mode`` (strict | truncate | same)."""
    if mode == "same":
        return int(math.ceil(size / s))
    out = (size - k + 2 * p) // s + 1
    if out <= 0:
        raise ValueError(
            f"Invalid configuration or input: input size {size} with "
            f"kernel {k}, stride {s}, padding {p} gives non-positive "
            f"output size {out} — input is smaller than the (padded) "
            "kernel")
    if mode == "strict" and (size - k + 2 * p) % s != 0:
        raise ValueError(
            f"ConvolutionMode.Strict: (in={size} - k={k} + 2*p={p}) not "
            f"divisible by stride {s}; use mode='truncate' or 'same'")
    return out


def validate_conv_geometry(layer, kind: str) -> None:
    """Kernel, stride and padding sanity shared by conv and pooling."""
    label = getattr(layer, "name", None) or type(layer).__name__
    kh, kw = layer.kernel_size
    sh, sw = layer.stride
    ph, pw = layer.padding
    if kh <= 0 or kw <= 0:
        raise ValueError(f"Invalid {kind} configuration for layer "
                         f"'{label}': kernel {layer.kernel_size} must be "
                         "positive")
    if sh <= 0 or sw <= 0:
        raise ValueError(f"Invalid {kind} configuration for layer "
                         f"'{label}': stride {layer.stride} must be "
                         "positive")
    if ph < 0 or pw < 0:
        raise ValueError(f"Invalid {kind} configuration for layer "
                         f"'{label}': padding {layer.padding} must be "
                         "non-negative")


def same_padding(n: int, k: int, s: int, dilation: int = 1) -> tuple:
    """XLA's SAME padding ``(lo, hi)`` of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def _spatial_padding(mode, x_hw, kernel, stride, padding, dilation=(1, 1)):
    """``((lo_h, hi_h), (lo_w, hi_w))`` for a window layer."""
    if mode == "same":
        return tuple(same_padding(n, k, s, d) for n, k, s, d
                     in zip(x_hw, kernel, stride, dilation))
    return tuple((p, p) for p in padding)


def _cudnn_flags():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Convolution(torch.autograd.Function):
    """``aten.convolution`` over channels-first views whose forward AND
    backward run under the layers' cuDNN flags (the backward is a separate
    call, made by autograd outside the layer, so a context around the
    forward alone would leave it on the process-wide flags)."""

    @staticmethod
    def forward(ctx, x, w, stride, dilation, transposed, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, dilation, transposed, groups)
        zeros = [0] * len(stride)
        with _cudnn_flags():
            return torch.ops.aten.convolution(x, w, None, stride, zeros,
                                              dilation, transposed, zeros,
                                              groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, dilation, transposed, groups = ctx.conf
        zeros = [0] * len(stride)
        with _cudnn_flags():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, zeros, dilation, transposed, zeros,
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return gx, gw, None, None, None, None


def conv_nd(x_cf, w, stride, dilation=None, transposed=False, groups=1):
    """Unpadded convolution of a channels-first ``x_cf`` with a torch-layout
    weight under the layers' flags (see ``_Convolution``)."""
    stride = list(stride)
    dilation = list(dilation or [1] * len(stride))
    return _Convolution.apply(x_cf, w, stride, dilation, transposed, groups)


def conv2d_nhwc(x, W, stride, pads, dilation=(1, 1), groups=1):
    """XLA's ``conv_general_dilated`` (NHWC, HWIO) with explicit per-side
    padding ``pads = ((lo_h, hi_h), (lo_w, hi_w))``."""
    xc = x.permute(0, 3, 1, 2)
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        xc = F.pad(xc, (pl, pr, pt, pb))
    out = conv_nd(xc, W.permute(3, 2, 0, 1), stride, dilation,
                  groups=groups)
    return out.permute(0, 2, 3, 1)


def _dequant(params, name, x):
    """The weight ``name`` in x's dtype and its per-output-channel int8
    scale (None for a full-precision weight)."""
    scale = params.get(name + "_scale")
    W = params[name] if scale is None else params[name].to(x.dtype)
    return W, scale


def _scaled(out, scale, x):
    return out if scale is None else (out * scale).to(x.dtype)


@register_serializable
@dataclass
class ConvolutionLayer(BaseLayer):
    """2-D convolution. Kernel ``[kh, kw, c_in, c_out]`` (HWIO), arrays
    NHWC. Serves int8 kernels carrying a ``W_scale`` sibling
    (``optimize/quantize.py``): the kernel is widened to x's dtype and the
    per-output-channel scale applied to the convolution's output, then the
    bias added, in the JAX layer's order."""

    n_in: int = 0   # input channels (from the InputType)
    n_out: int = 0  # output channels
    kernel_size: tuple = (5, 5)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)
    convolution_mode: str = "truncate"  # strict | truncate | same
    dilation: tuple = (1, 1)

    INPUT_KIND = "cnn"
    DEFAULT_ACTIVATION = "identity"
    QUANT_PARAMS = ("W",)

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)

    def validate(self) -> None:
        validate_conv_geometry(self, "convolution")
        super().validate()

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            if input_type.kind not in ("convolutional",
                                       "convolutional_flat"):
                raise ValueError(f"{type(self).__name__} expects CNN "
                                 f"input, got {input_type}")
            self.n_in = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        h = conv_out_size(input_type.height, kh, sh, ph,
                          self.convolution_mode)
        w = conv_out_size(input_type.width, kw, sw, pw,
                          self.convolution_mode)
        return InputType.convolutional(h, w, self.n_out)

    def param_order(self):
        return ["W", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        kh, kw = self.kernel_size
        W = self._init_w(gen, (kh, kw, self.n_in, self.n_out),
                         self.n_in * kh * kw, self.n_out * kh * kw, dtype,
                         device)
        return {"W": W, "b": self._bias(self.n_out, dtype, device)}

    def _pads(self, x):
        return _spatial_padding(self.convolution_mode, x.shape[1:3],
                                self.kernel_size, self.stride, self.padding,
                                self.dilation)

    def preactivate(self, params, x):
        W, scale = _dequant(params, "W", x)
        out = conv2d_nhwc(x, W, self.stride, self._pads(x), self.dilation)
        return _scaled(out, scale, x) + params["b"]

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        return self.act()(self.preactivate(params, x)), state


def conv_transpose_padding(k: int, s: int, mode: str, p: int) -> tuple:
    """``lax.conv_transpose``'s padding ``(lo, hi)`` of the stride-dilated
    input: XLA's SAME rule, or ``k - 1 - p`` each side."""
    if mode != "same":
        return k - 1 - p, k - 1 - p
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return lo, pad_len - lo


@register_serializable
@dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution as ``lax.conv_transpose`` computes it (kernel
    not flipped): the correlation of the stride-dilated input, padded by
    ``conv_transpose_padding``, with W. PyTorch's transposed convolution
    with the spatially flipped kernel gives the fully padded result
    (``k - 1`` each side); the wanted padding is then a crop (or a zero
    pad) of that, since ``output_padding`` cannot express every case."""

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        if self.convolution_mode == "same":
            h, w = input_type.height * sh, input_type.width * sw
        else:
            h = sh * (input_type.height - 1) + kh - 2 * ph
            w = sw * (input_type.width - 1) + kw - 2 * pw
        return InputType.convolutional(h, w, self.n_out)

    def preactivate(self, params, x):
        W, scale = _dequant(params, "W", x)
        # [kh, kw, cin, cout] -> [cin, cout, kh, kw], flipped in space
        w = W.permute(2, 3, 0, 1).flip(2, 3)
        full = conv_nd(x.permute(0, 3, 1, 2), w, self.stride,
                       transposed=True)
        (lh, hh), (lw, hw) = (
            conv_transpose_padding(k, s, self.convolution_mode, p)
            for k, s, p in zip(self.kernel_size, self.stride, self.padding))
        kh, kw = self.kernel_size
        out = F.pad(full, (lw - (kw - 1), hw - (kw - 1),
                           lh - (kh - 1), hh - (kh - 1)))
        return _scaled(out.permute(0, 2, 3, 1), scale, x) + params["b"]


@register_serializable
@dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise (``dW [kh, kw, 1, n_in·depth_multiplier]``, one group per
    input channel) then pointwise (``pW [1, 1, mid, n_out]``) convolution.
    Each stage applies its own int8 scale right after its convolution."""

    depth_multiplier: int = 1

    QUANT_PARAMS = ("dW", "pW")

    def param_order(self):
        return ["dW", "pW", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        kh, kw = self.kernel_size
        mid = self.n_in * self.depth_multiplier
        dW = self._init_w(gen, (kh, kw, 1, mid), kh * kw,
                          kh * kw * self.depth_multiplier, dtype, device)
        pW = self._init_w(gen, (1, 1, mid, self.n_out), mid, self.n_out,
                          dtype, device)
        return {"dW": dW, "pW": pW,
                "b": self._bias(self.n_out, dtype, device)}

    def preactivate(self, params, x):
        dW, dscale = _dequant(params, "dW", x)
        # the JAX layer's depthwise stage takes no dilation
        pads = _spatial_padding(self.convolution_mode, x.shape[1:3],
                                self.kernel_size, self.stride, self.padding)
        depthwise = _scaled(conv2d_nhwc(x, dW, self.stride, pads,
                                        groups=self.n_in), dscale, x)
        pW, pscale = _dequant(params, "pW", x)
        pointwise = conv2d_nhwc(depthwise, pW, (1, 1), ((0, 0), (0, 0)))
        return _scaled(pointwise, pscale, x) + params["b"]


@register_serializable
@dataclass
class Convolution1DLayer(BaseLayer):
    """1-D convolution over ``[batch, time, features]``, W ``[k, n_in,
    n_out]``."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 5
    stride: int = 1
    padding: int = 0
    convolution_mode: str = "same"

    INPUT_KIND = "rnn"
    DEFAULT_ACTIVATION = "identity"

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        if t is not None:
            t = conv_out_size(t, self.kernel_size, self.stride, self.padding,
                              self.convolution_mode)
        return InputType.recurrent(self.n_out, t)

    def param_order(self):
        return ["W", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        k = self.kernel_size
        W = self._init_w(gen, (k, self.n_in, self.n_out), self.n_in * k,
                         self.n_out * k, dtype, device)
        return {"W": W, "b": self._bias(self.n_out, dtype, device)}

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        lo, hi = (same_padding(x.shape[1], self.kernel_size, self.stride)
                  if self.convolution_mode == "same"
                  else (self.padding, self.padding))
        xc = x.permute(0, 2, 1)
        if lo or hi:
            xc = F.pad(xc, (lo, hi))
        out = conv_nd(xc, params["W"].permute(2, 1, 0), [self.stride])
        return self.act()(out.permute(0, 2, 1) + params["b"]), state


def _pool_sum(xp, kernel, stride):
    """Window sums of a padded channels-first tensor."""
    if xp.dim() == 3:
        return F.avg_pool2d(xp[..., None], (kernel[0], 1), (stride[0], 1),
                            divisor_override=1)[..., 0]
    return F.avg_pool2d(xp, kernel, stride, divisor_override=1)


def pool_windows(xc, pooling_type, kernel, stride, pads, pnorm=2):
    """``lax.reduce_window`` pooling of a channels-first ``xc`` (3-D or
    4-D) over its spatial axes, with explicit per-side padding ``pads``
    (a ``(lo, hi)`` per spatial axis)."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    padded = any(flat)
    pt = pooling_type.lower()
    if pt == "max":
        xp = F.pad(xc, flat, value=float("-inf")) if padded else xc
        if xc.dim() == 3:
            return F.max_pool1d(xp, kernel[0], stride[0])
        return F.max_pool2d(xp, kernel, stride)
    if pt in ("avg", "sum"):
        out = _pool_sum(F.pad(xc, flat) if padded else xc, kernel, stride)
        if pt == "sum":
            return out
        if not padded:
            return out / math.prod(kernel)
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                          device=xc.device)
        return out / _pool_sum(F.pad(ones, flat), kernel, stride)
    if pt == "pnorm":
        p = float(pnorm)
        xp = xc.abs() ** p
        return _pool_sum(F.pad(xp, flat) if padded else xp, kernel,
                         stride) ** (1.0 / p)
    raise ValueError(f"Unknown pooling type '{pooling_type}'")


@register_serializable
@dataclass
class SubsamplingLayer(Layer):
    """2-D pooling: max, avg, sum or pnorm."""

    pooling_type: str = "max"
    kernel_size: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: tuple = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    INPUT_KIND = "cnn"

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def validate(self) -> None:
        validate_conv_geometry(self, "subsampling")
        super().validate()

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        h = conv_out_size(input_type.height, kh, sh, ph,
                          self.convolution_mode)
        w = conv_out_size(input_type.width, kw, sw, pw,
                          self.convolution_mode)
        return InputType.convolutional(h, w, input_type.channels)

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        x = self.apply_input_dropout(x, train=train, rng=rng)
        pads = _spatial_padding(self.convolution_mode, x.shape[1:3],
                                self.kernel_size, self.stride, self.padding)
        out = pool_windows(x.permute(0, 3, 1, 2), self.pooling_type,
                           self.kernel_size, self.stride, pads, self.pnorm)
        return out.permute(0, 2, 3, 1), state


@register_serializable
@dataclass
class Subsampling1DLayer(Layer):
    """1-D pooling over ``[batch, time, features]``: max, avg or sum."""

    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = "truncate"

    INPUT_KIND = "rnn"

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        if t is not None:
            t = conv_out_size(t, self.kernel_size, self.stride, self.padding,
                              self.convolution_mode)
        return InputType.recurrent(input_type.size, t)

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        pads = ((same_padding(x.shape[1], self.kernel_size, self.stride),)
                if self.convolution_mode == "same"
                else ((self.padding, self.padding),))
        pt = self.pooling_type.lower()
        out = pool_windows(x.permute(0, 2, 1),
                           "max" if pt == "max" else
                           ("avg" if pt == "avg" else "sum"),
                           (self.kernel_size,), (self.stride,), pads)
        return out.permute(0, 2, 1), state


@register_serializable
@dataclass
class ZeroPaddingLayer(Layer):
    """Spatial zero padding (top, bottom, left, right)."""

    pad_top: int = 0
    pad_bottom: int = 0
    pad_left: int = 0
    pad_right: int = 0

    INPUT_KIND = "cnn"

    @staticmethod
    def of(pad):
        if isinstance(pad, int):
            return ZeroPaddingLayer(pad_top=pad, pad_bottom=pad,
                                    pad_left=pad, pad_right=pad)
        if len(pad) == 2:
            return ZeroPaddingLayer(pad_top=pad[0], pad_bottom=pad[0],
                                    pad_left=pad[1], pad_right=pad[1])
        return ZeroPaddingLayer(pad_top=pad[0], pad_bottom=pad[1],
                                pad_left=pad[2], pad_right=pad[3])

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(
            input_type.height + self.pad_top + self.pad_bottom,
            input_type.width + self.pad_left + self.pad_right,
            input_type.channels)

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        return F.pad(x, (0, 0, self.pad_left, self.pad_right, self.pad_top,
                         self.pad_bottom)), state


@register_serializable
@dataclass
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling by an integer factor."""

    size: int = 2

    INPUT_KIND = "cnn"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(input_type.height * self.size,
                                       input_type.width * self.size,
                                       input_type.channels)

    def forward(self, params, state, x, *, mask=None, train=False,
                rng=None):
        out = x.repeat_interleave(self.size, dim=1)
        return out.repeat_interleave(self.size, dim=2), state
