"""The port's convolution, pooling and normalization layers against the JAX
package's (``nn/conf/layers/{convolution,pooling,normalization}.py``) on
the CPU: the same seeded numpy parameters and input go through both, and
the forward must agree within 1e-5 absolute (f32), the gradients of
``sum(out * R)`` with respect to every parameter and the input within
1e-5 of each leaf's max|g|, and batch norm's new running statistics
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-5

_MODULES = {
    "ConvolutionLayer": "convolution", "Deconvolution2D": "convolution",
    "SeparableConvolution2D": "convolution",
    "Convolution1DLayer": "convolution", "SubsamplingLayer": "convolution",
    "Subsampling1DLayer": "convolution", "ZeroPaddingLayer": "convolution",
    "Upsampling2D": "convolution", "GlobalPoolingLayer": "pooling",
    "BatchNormalization": "normalization",
    "LocalResponseNormalization": "normalization",
}

#: case -> (layer class, fields, input shape[, train, mask])
CASES = {
    "conv_truncate_k3_s1": ("ConvolutionLayer",
                            dict(n_out=4, kernel_size=3), (2, 9, 9, 3)),
    "conv_truncate_k4_s2": ("ConvolutionLayer",
                            dict(n_out=5, kernel_size=4, stride=2),
                            (2, 10, 11, 3)),
    "conv_same_k5_s1": ("ConvolutionLayer",
                        dict(n_out=4, kernel_size=5,
                             convolution_mode="same"), (2, 8, 8, 2)),
    "conv_same_k4_s2": ("ConvolutionLayer",
                        dict(n_out=3, kernel_size=4, stride=2,
                             convolution_mode="same"), (2, 9, 10, 2)),
    "conv_same_k3_s2": ("ConvolutionLayer",
                        dict(n_out=3, kernel_size=(3, 2), stride=2,
                             convolution_mode="same"), (2, 7, 8, 2)),
    "conv_strict_k3_s2": ("ConvolutionLayer",
                          dict(n_out=4, kernel_size=3, stride=2,
                               convolution_mode="strict"), (2, 9, 9, 2)),
    "conv_dilation2": ("ConvolutionLayer",
                       dict(n_out=4, kernel_size=3, dilation=2,
                            convolution_mode="same"), (2, 9, 9, 2)),
    "conv_explicit_padding": ("ConvolutionLayer",
                              dict(n_out=4, kernel_size=3, stride=2,
                                   padding=(1, 2)), (2, 8, 9, 3)),
    "deconv_same_s2": ("Deconvolution2D",
                       dict(n_out=3, kernel_size=3, stride=2,
                            convolution_mode="same"), (2, 5, 6, 2)),
    "deconv_same_k4_s2": ("Deconvolution2D",
                          dict(n_out=3, kernel_size=4, stride=2,
                               convolution_mode="same"), (2, 5, 5, 2)),
    "deconv_truncate_s2": ("Deconvolution2D",
                           dict(n_out=3, kernel_size=3, stride=2),
                           (2, 5, 6, 2)),
    "deconv_truncate_pad1_s2": ("Deconvolution2D",
                                dict(n_out=2, kernel_size=4, stride=2,
                                     padding=1), (2, 4, 5, 3)),
    "separable_same_s2": ("SeparableConvolution2D",
                          dict(n_out=5, kernel_size=3, stride=2,
                               depth_multiplier=2,
                               convolution_mode="same"), (2, 9, 8, 3)),
    "conv1d_same_s2": ("Convolution1DLayer",
                       dict(n_out=4, kernel_size=3, stride=2), (2, 11, 3)),
    "conv1d_truncate_pad1": ("Convolution1DLayer",
                             dict(n_out=4, kernel_size=4, padding=1,
                                  convolution_mode="truncate"), (2, 10, 3)),
    "pool_max_truncate": ("SubsamplingLayer", dict(), (2, 8, 9, 3)),
    "pool_max_same_asym": ("SubsamplingLayer",
                           dict(kernel_size=(3, 2), stride=2,
                                convolution_mode="same"), (2, 8, 9, 3)),
    "pool_avg_same_asym": ("SubsamplingLayer",
                           dict(pooling_type="avg", kernel_size=(3, 2),
                                stride=2, convolution_mode="same"),
                           (2, 8, 9, 3)),
    "pool_sum_same_asym": ("SubsamplingLayer",
                           dict(pooling_type="sum", kernel_size=(3, 2),
                                stride=2, convolution_mode="same"),
                           (2, 8, 9, 3)),
    "pool_pnorm_same_asym": ("SubsamplingLayer",
                             dict(pooling_type="pnorm", pnorm=3,
                                  kernel_size=(3, 2), stride=2,
                                  convolution_mode="same"), (2, 8, 9, 3)),
    "pool_avg_padded_overlap": ("SubsamplingLayer",
                                dict(pooling_type="avg", kernel_size=3,
                                     stride=2, padding=1), (2, 9, 9, 2)),
    "pool_max_padded_overlap": ("SubsamplingLayer",
                                dict(kernel_size=3, stride=2, padding=1),
                                (2, 9, 9, 2)),
    "pool1d_max_same": ("Subsampling1DLayer",
                        dict(kernel_size=3, stride=2,
                             convolution_mode="same"), (2, 9, 4)),
    "pool1d_avg_same": ("Subsampling1DLayer",
                        dict(pooling_type="avg", kernel_size=3, stride=2,
                             convolution_mode="same"), (2, 10, 4)),
    "pool1d_sum_truncate": ("Subsampling1DLayer",
                            dict(pooling_type="sum", kernel_size=2,
                                 stride=1, padding=1), (2, 7, 4)),
    "zero_padding": ("ZeroPaddingLayer",
                     dict(pad_top=1, pad_bottom=2, pad_left=0,
                          pad_right=3), (2, 4, 5, 2)),
    "upsampling": ("Upsampling2D", dict(size=3), (2, 3, 4, 2)),
    "global_max": ("GlobalPoolingLayer", dict(), (2, 5, 6, 3)),
    "global_avg": ("GlobalPoolingLayer", dict(pooling_type="avg"),
                   (2, 5, 6, 3)),
    "global_sum": ("GlobalPoolingLayer", dict(pooling_type="sum"),
                   (2, 5, 6, 3)),
    "global_pnorm": ("GlobalPoolingLayer",
                     dict(pooling_type="pnorm", pnorm=3), (2, 5, 6, 3)),
    "global_avg_masked_time": ("GlobalPoolingLayer",
                               dict(pooling_type="avg"), (3, 6, 4),
                               False, True),
    "global_max_masked_time": ("GlobalPoolingLayer", dict(), (3, 6, 4),
                               False, True),
    "bn_train_nhwc": ("BatchNormalization", dict(), (4, 5, 5, 3), True),
    "bn_eval_nhwc": ("BatchNormalization", dict(), (4, 5, 5, 3), False),
    "bn_train_ff": ("BatchNormalization", dict(decay=0.8), (6, 7), True),
    "bn_locked_train": ("BatchNormalization",
                        dict(lock_gamma_beta=True), (4, 3, 3, 2), True),
    "lrn": ("LocalResponseNormalization", dict(alpha=1e-2), (2, 4, 4, 7)),
    "lrn_n3": ("LocalResponseNormalization", dict(n=3, k=1.0, beta=0.5),
               (2, 3, 3, 6)),
}


def _input_type(it, shape):
    if len(shape) == 4:
        return it.convolutional(*shape[1:])
    if len(shape) == 3:
        return it.recurrent(shape[2], shape[1])
    return it.feed_forward(shape[1])


def _layers(cls, fields, shape):
    """The JAX and the port layer of one configuration, finalized and with
    ``n_in`` inferred from the input shape."""
    import importlib

    out = []
    for pkg, it in (("deeplearning4j_tpu", JInputType),
                    ("deeplearning4j_torch", TInputType)):
        mod = importlib.import_module(
            f"{pkg}.nn.conf.layers.{_MODULES[cls]}")
        layer = getattr(mod, cls)(**fields)
        layer.finalize(None)
        layer.set_n_in(_input_type(it, shape))
        out.append(layer)
    return out


def _numpy_params(jlayer, rs):
    params = jax.device_get(jlayer.init_params(jax.random.PRNGKey(0)))
    return {k: (1.0 + 0.2 * rs.randn(*v.shape) if k == "gamma"
                else 0.5 * rs.randn(*v.shape)).astype(np.float32)
            for k, v in params.items()}


def _numpy_state(jlayer, rs):
    state = jax.device_get(jlayer.init_state())
    return {k: (0.5 + rs.rand(*v.shape) if k == "var"
                else 0.3 * rs.randn(*v.shape)).astype(np.float32)
            for k, v in state.items()}


def _assert_grads(jg, tg, what):
    jg, tg = np.asarray(jg), tg.detach().numpy()
    scale = max(float(np.abs(jg).max()), 1e-30)
    err = float(np.abs(jg - tg).max())
    assert err <= GRAD_RTOL * scale, f"{what}: {err} > {GRAD_RTOL} * {scale}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    cls, fields, shape, *rest = CASES[case]
    train = bool(rest[0]) if rest else False
    masked = bool(rest[1]) if len(rest) > 1 else False
    jl, tl = _layers(cls, fields, shape)
    rs = np.random.RandomState(sum(map(ord, case)))
    params = _numpy_params(jl, rs)
    state = _numpy_state(jl, rs)
    x = rs.randn(*shape).astype(np.float32)
    if cls == "SubsamplingLayer" and fields.get("pooling_type") == "pnorm":
        x = x + np.sign(x)  # keep |x| away from 0, where pnorm is not smooth
    mask = None
    if masked:
        mask = np.ones(shape[:2], np.float32)
        mask[0, 4:] = 0
        mask[2, 1:] = 0

    def jfwd(p, xx):
        return jl.forward(p, jax.tree_util.tree_map(jnp.asarray, state), xx,
                          mask=None if mask is None else jnp.asarray(mask),
                          train=train)

    jout, jstate = jfwd(jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, tstate = tl.forward(tp, {k: torch.from_numpy(v)
                                   for k, v in state.items()}, tx,
                              mask=None if mask is None
                              else torch.from_numpy(mask), train=train)
    assert tuple(tout.shape) == tuple(jout.shape)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=FWD_ATOL, rtol=0)
    # the output type the builders infer is the shape the layer makes
    ot = tl.output_type(_input_type(TInputType, shape))
    assert ot.array_shape(shape[0]) == tuple(tout.shape)
    for k in state:
        np.testing.assert_allclose(tstate[k].detach().numpy(),
                                   np.asarray(jstate[k]), atol=1e-6, rtol=0)

    R = rs.randn(*tout.shape).astype(np.float32)
    jg_p, jg_x = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx)[0] * R),
                          argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    (tout * torch.from_numpy(R)).sum().backward()
    _assert_grads(jg_x, tx.grad, f"{case} d/dx")
    for k in params:
        _assert_grads(jg_p[k], tp[k].grad, f"{case} d/d{k}")


@pytest.mark.parametrize("cls", ["ConvolutionLayer",
                                 "SeparableConvolution2D"])
def test_quantized_conv_matches_jax(cls):
    """An int8 kernel (JAX's ``quantize_array`` codes and scales, equal bit
    for bit in the port) through both layers' dequant path."""
    from deeplearning4j_torch.optimize.quantize import (
        quantize_array as t_quant)
    from deeplearning4j_tpu.optimize.quantize import (
        quantize_array as j_quant)

    shape = (2, 8, 9, 3)
    jl, tl = _layers(cls, dict(n_out=5, kernel_size=3, stride=2,
                               convolution_mode="same"), shape)
    rs = np.random.RandomState(5)
    params = _numpy_params(jl, rs)
    jq, tq = dict(params), dict(params)
    for name in jl.QUANT_PARAMS:
        q, s = (np.asarray(a) for a in j_quant(jnp.asarray(params[name])))
        tq_q, tq_s = t_quant(params[name])
        np.testing.assert_array_equal(tq_q.numpy(), q)
        np.testing.assert_array_equal(tq_s.numpy(), s)
        jq[name], jq[name + "_scale"] = q, s
        tq[name], tq[name + "_scale"] = tq_q, tq_s
    x = rs.randn(*shape).astype(np.float32)
    jout, _ = jl.forward(jax.tree_util.tree_map(jnp.asarray, jq), {},
                         jnp.asarray(x))
    tout, _ = tl.forward({k: torch.as_tensor(v) for k, v in tq.items()}, {},
                         torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["strict_indivisible", "kernel_too_big",
                                 "zero_stride"])
def test_geometry_errors_match_jax(bad):
    """Both packages refuse the same bad geometries at build time."""
    from deeplearning4j_torch.nn.conf.layers import convolution as tc
    from deeplearning4j_tpu.nn.conf.layers import convolution as jc

    fields, shape = {
        "strict_indivisible": (dict(n_out=2, kernel_size=3, stride=2,
                                    convolution_mode="strict"),
                               (1, 8, 8, 1)),
        "kernel_too_big": (dict(n_out=2, kernel_size=9), (1, 8, 8, 1)),
        "zero_stride": (dict(n_out=2, kernel_size=3, stride=0),
                        (1, 8, 8, 1)),
    }[bad]
    for mod, it in ((jc, JInputType), (tc, TInputType)):
        layer = mod.ConvolutionLayer(**fields)
        layer.finalize(None)
        with pytest.raises(ValueError):
            layer.set_n_in(it.convolutional(*shape[1:]))
            layer.validate()
            layer.output_type(it.convolutional(*shape[1:]))
