"""Port parity of the activation and loss registries, the dropout draw and
the weight initialisers, on the CPU:

- every activation of ``deeplearning4j_tpu/ops/activations.py`` is in the
  port under its name and matches JAX's within 1e-6 (absolute, plus 1e-6
  of the value);
- every loss of ``ops/losses.py`` (paired with the output activations it
  is used with) matches JAX's ``per_example`` and masked, weighted
  ``score`` within 1e-6 relative to the largest value;
- ``ops/random.bernoulli`` is ``jax.random.bernoulli`` bit for bit;
- ``nn/weights.py``: every ``weight_init`` scheme's scale is JAX's formula
  (the port's and JAX's draws of a 400 x 300 weight have standard
  deviations within 3 % and the same bound for the uniform schemes; the
  deterministic schemes are equal), and ``Distribution`` draws its
  moments. The draws themselves differ: the port draws from a
  ``torch.Generator``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import weights as jw  # noqa: E402
from deeplearning4j_tpu.ops import activations as ja  # noqa: E402
from deeplearning4j_tpu.ops import losses as jl  # noqa: E402
from deeplearning4j_torch.nn import weights as tw  # noqa: E402
from deeplearning4j_torch.ops import activations as ta  # noqa: E402
from deeplearning4j_torch.ops import losses as tl  # noqa: E402
from deeplearning4j_torch.ops import random as tr  # noqa: E402

pytestmark = pytest.mark.torch_port


def test_registries_hold_the_same_names():
    assert set(ta._REGISTRY) == set(ja._REGISTRY)
    assert set(tl._REGISTRY) == set(jl._REGISTRY)


@pytest.mark.parametrize("name", sorted(ja._REGISTRY))
def test_activation_matches_jax(name):
    rs = np.random.RandomState(sorted(ja._REGISTRY).index(name))
    x = (rs.randn(4, 7, 9) * 3).astype(np.float32)
    x[0, 0, :3] = [0.0, -1e-3, 30.0]
    ref = np.asarray(ja.get_activation(name)(jnp.asarray(x)))
    got = ta.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


#: loss -> the output activations it is checked under
LOSS_ACTS = {
    "mcxent": ["softmax", "sigmoid"],
    "negativeloglikelihood": ["softmax"],
    "xent": ["sigmoid", "softmax"],
    "reconstruction_crossentropy": ["sigmoid"],
    "mse": ["identity", "tanh"],
    "squared_loss": ["identity"],
    "l2": ["identity"],
    "mean_absolute_error": ["identity"],
    "l1": ["identity"],
    "mean_absolute_percentage_error": ["identity"],
    "mean_squared_logarithmic_error": ["identity", "relu"],
    "kl_divergence": ["softmax"],
    "poisson": ["softplus"],
    "cosine_proximity": ["identity"],
    "hinge": ["identity", "tanh"],
    "squared_hinge": ["identity"],
}
CASES = [(loss, act) for loss in sorted(LOSS_ACTS) for act in LOSS_ACTS[loss]]


def _labels(loss, rs, shape):
    if loss in ("hinge", "squared_hinge"):
        return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)
    if loss in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        y = rs.rand(*shape).astype(np.float32)
        return y / y.sum(-1, keepdims=True)
    if loss in ("xent", "reconstruction_crossentropy"):
        return (rs.rand(*shape) > 0.5).astype(np.float32)
    if loss == "poisson":
        return rs.poisson(2.0, shape).astype(np.float32)
    y = rs.randn(*shape).astype(np.float32)
    if loss == "mean_absolute_percentage_error":
        y[0, 0] = 0.0                       # takes the _EPS denominator
    return y


def test_every_loss_is_checked():
    assert set(LOSS_ACTS) == set(jl._REGISTRY)


@pytest.mark.parametrize("loss,act", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_loss_matches_jax(loss, act):
    rs = np.random.RandomState(CASES.index((loss, act)))
    shape = (5, 3, 6)
    pre = (rs.randn(*shape) * 2).astype(np.float32)
    y = _labels(loss, rs, shape)
    w = rs.rand(shape[-1]).astype(np.float32) + 0.5
    mask = np.ones(shape[:2], np.float32)
    mask[1, 1:] = 0
    mask[3] = 0
    jf, tf = jl.get_loss(loss), tl.get_loss(loss)
    jact, tact = ja.get_activation(act), ta.get_activation(act)
    J = [jnp.asarray(a) for a in (y, pre, w, mask)]
    T = [torch.from_numpy(a) for a in (y, pre, w, mask)]
    for weights in (False, True):
        ref = np.asarray(jf.per_example(J[0], J[1], jact,
                                        J[2] if weights else None))
        got = tf.per_example(T[0], T[1], tact,
                             T[2] if weights else None).numpy()
        assert got.shape == ref.shape == shape[:2]
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref, atol=1e-6 * scale, rtol=0)
        for m in (None, 3):
            js = float(jf.score(J[0], J[1], jact, None if m is None else J[m],
                                J[2] if weights else None))
            ts = float(tf.score(T[0], T[1], tact, None if m is None else T[m],
                                T[2] if weights else None))
            assert ts == pytest.approx(js, abs=1e-6 * scale)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
@pytest.mark.parametrize("p", [0.9, 0.5, 1.0 - 0.1])
def test_bernoulli_is_jax_bitwise(seed, p):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tk = tr.fold_in(tr.PRNGKey(seed, device="cpu"), 11)
    for shape in [(3, 5, 7), (64,), (2, 9, 33)]:
        ref = np.asarray(jax.random.bernoulli(jk, p, shape))
        got = tr.bernoulli(tk, p, shape).numpy()
        np.testing.assert_array_equal(got, ref)


NORMAL = ["normal", "lecun_normal", "xavier", "xavier_fan_in",
          "xavier_legacy", "relu"]
UNIFORM = ["xavier_uniform", "relu_uniform", "uniform", "sigmoid_uniform",
           "lecun_uniform"]


@pytest.mark.parametrize("scheme", NORMAL + UNIFORM)
def test_init_scheme_scale_matches_jax(scheme):
    shape, fan_in, fan_out = (400, 300), 400.0, 300.0
    ref = np.asarray(jw.init_weight(jax.random.PRNGKey(1), shape, fan_in,
                                    fan_out, scheme))
    gen = torch.Generator().manual_seed(1)
    got = tw.init_weight(gen, shape, fan_in, fan_out, scheme).numpy()
    assert got.shape == shape and got.dtype == np.float32
    kind, scale = tw.SCHEMES[scheme]
    s = scale(shape, fan_in, fan_out)
    assert abs(got.mean()) < 0.02 * s
    assert got.std() == pytest.approx(ref.std(), rel=0.03)
    if kind == "uniform":
        # U(-s, s): the bound is JAX's formula, std s/sqrt(3)
        assert np.abs(got).max() <= s and np.abs(ref).max() <= s
        assert np.abs(got).max() > 0.999 * s
        assert got.std() == pytest.approx(s / math.sqrt(3), rel=0.02)
    else:
        assert got.std() == pytest.approx(s, rel=0.02)


@pytest.mark.parametrize("scheme", ["zero", "ones", "identity"])
def test_deterministic_schemes_equal_jax(scheme):
    ref = np.asarray(jw.init_weight(jax.random.PRNGKey(0), (6, 6), 6.0, 6.0,
                                    scheme))
    got = tw.init_weight(torch.Generator().manual_seed(0), (6, 6), 6.0, 6.0,
                         scheme).numpy()
    np.testing.assert_array_equal(got, ref)


def test_distribution_draws_its_moments():
    gen = torch.Generator().manual_seed(3)
    n = tw.init_weight(gen, (300, 300), 1.0, 1.0, "distribution",
                       tw.Distribution.normal(0.5, 2.0)).numpy()
    assert n.mean() == pytest.approx(0.5, abs=0.03)
    assert n.std() == pytest.approx(2.0, rel=0.02)
    u = tw.init_weight(gen, (300, 300), 1.0, 1.0, "distribution",
                       tw.Distribution.uniform(-0.5, 1.5)).numpy()
    assert u.min() >= -0.5 and u.max() < 1.5
    assert u.mean() == pytest.approx(0.5, abs=0.02)
    with pytest.raises(ValueError, match="Unknown weight init"):
        tw.init_weight(gen, (2, 2), 2.0, 2.0, "nosuch")
    with pytest.raises(ValueError, match="square"):
        tw.init_weight(gen, (2, 3), 2.0, 3.0, "identity")


def test_layer_draws_with_its_weight_init():
    """A Dense layer built with ``weight_init="relu"`` draws N(0, 2/n_in)
    and biases at ``bias_init``, in the conf's dtype."""
    from deeplearning4j_torch.nn.conf.layers.core import DenseLayer

    layer = DenseLayer(n_in=500, n_out=200, weight_init="relu",
                       bias_init=0.25)
    layer.finalize()
    p = layer.init_params(torch.Generator().manual_seed(0), torch.bfloat16)
    assert p["W"].dtype == torch.bfloat16
    assert float(p["W"].float().std()) == pytest.approx(
        math.sqrt(2.0 / 500), rel=0.03)
    assert torch.all(p["b"] == 0.25)
