"""The port's solvers (``optimize/solvers.py``) and gradient check
(``gradientcheck.py``) against the JAX package's on the CPU:

- counterparts of ``tests/test_solvers.py::TestSolvers``: each optimizer
  lowers the loss, L-BFGS beats line gradient descent on one budget, the
  ``Solver`` facade dispatches (and refuses an unknown name), SGD takes one
  ``do_step``;
- each optimizer iteration by iteration against JAX's in f64 from the same
  weights: the same number of iterations, the same termination reason,
  losses within rtol 1e-9 and step sizes within rtol 1e-9;
- ``optimization_algo``: JAX's field, default and builder method, its JSON
  loading in both packages, and ``Solver(net)`` reading it as JAX's does;
- the termination conditions;
- counterparts of ``tests/test_gradients.py``: ``check_gradients`` passes
  on every case whose layers the port has (MLP with and without L1/L2,
  four losses, CNN, same-mode average pooling with zero padding, batch
  norm, layer norm, LRN, the recurrent layers, bidirectional LSTM,
  masking, global pooling, embedding, batch norm under a global L2), f64.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_torch.gradientcheck import check_gradients
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.optimize import solvers as ts
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork)
from deeplearning4j_tpu.optimize import solvers as js
from deeplearning4j_tpu.utils import serde as jserde

pytestmark = pytest.mark.torch_port

RTOL = 1e-9


def _conf(pkg, seed=3, algo=None):
    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
    inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
    upd = importlib.import_module(f"{pkg}.nn.updater")
    nb = (b.NeuralNetConfiguration.builder().seed(seed)
          .updater(upd.Sgd(learning_rate=0.1)).dtype("float64"))
    if algo:
        nb = nb.optimization_algo(algo)
    return (nb.list(core.DenseLayer(n_out=8, activation="tanh"),
                    core.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(inputs.InputType.feed_forward(4)).build())


def _net(seed=3):
    return MultiLayerNetwork(_conf("deeplearning4j_torch", seed)).init(
        device="cpu")


def _pair(seed=3):
    net = _net(seed)
    jnet = JMultiLayerNetwork(_conf("deeplearning4j_tpu", seed)).init(
        jax.tree_util.tree_map(jnp.asarray, {
            v: {k: t.numpy() for k, t in p.items()}
            for v, p in net.params.items()}))
    return jnet, net


def _data(n=40, seed=0):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 3, n)
    x = rs.randn(n, 4) + 1.5 * labels[:, None]
    return x, np.eye(3)[labels]


SOLVERS = ["LineGradientDescent", "ConjugateGradient", "LBFGS"]


@pytest.mark.parametrize("cls", SOLVERS)
def test_optimizer_reduces_loss(cls):
    net = _net()
    x, y = _data()
    s0 = net.score(x=x, y=y)
    final = getattr(ts, cls)(max_iterations=20).optimize(net, x, y)
    assert final < s0 * 0.6, (s0, final)
    assert abs(net.score(x=x, y=y) - final) < 1e-8


def _jax_run(cls, jnet, x, y, max_iterations, monkeypatch):
    """JAX's optimizer ``cls`` with its losses (every value-and-grad call)
    and line-search steps recorded; returns (final loss, losses after each
    accepted step, accepted steps, reason)."""
    losses, steps = [], []
    orig_ls = js.BackTrackLineSearch.optimize

    def ls(self, *a, **kw):
        s = orig_ls(self, *a, **kw)
        steps.append(s)
        return s

    monkeypatch.setattr(js.BackTrackLineSearch, "optimize", ls)
    opt = getattr(js, cls)(max_iterations=max_iterations)
    setup = opt._setup

    def recorded(net, x, y):
        flat0, unravel, value, vg = setup(net, x, y)

        def vg2(flat):
            out = vg(flat)
            losses.append(float(out[0]))
            return out

        return flat0, unravel, value, vg2

    opt._setup = recorded
    final = opt.optimize(jnet, x, y)
    monkeypatch.undo()
    accepted = [s for s in steps if s != 0.0]
    it_losses = losses[1:]
    if steps and steps[-1] == 0.0:
        reason = "zero_step"
    elif len(it_losses) >= 1 and js.EpsTermination().terminate(
            it_losses[-1], ([losses[0]] + it_losses)[-2]):
        reason = "terminated"
    else:
        reason = "max_iterations"
    return final, it_losses, accepted, reason


@pytest.mark.parametrize("cls", SOLVERS)
@pytest.mark.parametrize("iters", [4, 25])
def test_optimizer_iterations_match_jax(cls, iters, monkeypatch):
    jnet, net = _pair()
    x, y = _data()
    jfinal, jlosses, jsteps, jreason = _jax_run(cls, jnet, x, y, iters,
                                                monkeypatch)
    opt = getattr(ts, cls)(max_iterations=iters)
    final = opt.optimize(net, x, y)
    losses = [h[0] for h in opt.history]
    steps = [h[1] for h in opt.history]
    assert len(losses) == len(jlosses), (losses, jlosses)
    assert opt.reason == jreason
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=0)
    np.testing.assert_allclose(steps, jsteps, rtol=RTOL, atol=0)
    assert abs(final - jfinal) <= RTOL * abs(jfinal)
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=1e-8)


def test_lbfgs_converges_faster_than_line_gd():
    x, y = _data()
    l_gd = ts.LineGradientDescent(max_iterations=15).optimize(_net(), x, y)
    l_bfgs = ts.LBFGS(max_iterations=15).optimize(_net(), x, y)
    assert l_bfgs <= l_gd + 1e-9


def test_solver_facade_dispatch():
    net = _net()
    x, y = _data()
    s = ts.Solver(net, algorithm="lbfgs", max_iterations=10)
    assert isinstance(s.optimizer, ts.LBFGS)
    assert s.optimize(x, y) < 1.2
    with pytest.raises(ValueError, match="Unknown optimization"):
        ts.Solver(net, algorithm="newton_raphson")
    net = _net()
    before = net.iteration
    ts.Solver(net, algorithm="stochastic_gradient_descent").optimize(x, y)
    assert net.iteration == before + 1


def test_optimization_algo_field_matches_jax():
    """JAX's field, default and builder method; the global configuration's
    JSON loads in both packages; ``Solver(net)`` reads the net's
    configuration as JAX's does (a MultiLayerConfiguration carries no
    such field, so both take SGD)."""
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.utils import serde as tserde
    from deeplearning4j_tpu.nn.conf.builders import (
        NeuralNetConfiguration as JNeuralNetConfiguration)

    assert NeuralNetConfiguration().optimization_algo == \
        JNeuralNetConfiguration().optimization_algo == \
        "stochastic_gradient_descent"
    t = NeuralNetConfiguration.builder().seed(5).optimization_algo(
        "lbfgs").build()
    j = JNeuralNetConfiguration.builder().seed(5).optimization_algo(
        "lbfgs").build()
    assert json.loads(tserde.to_json(t)) == json.loads(jserde.to_json(j))
    assert tserde.from_json(jserde.to_json(j)).optimization_algo == "lbfgs"
    assert jserde.from_json(tserde.to_json(t)).optimization_algo == "lbfgs"
    jnet, net = _pair()
    assert (ts.Solver(net).optimizer is None) == \
        (js.Solver(jnet).optimizer is None)
    net.conf.optimization_algo = "conjugate_gradient"
    assert isinstance(ts.Solver(net).optimizer, ts.ConjugateGradient)


def test_termination_conditions_match_jax():
    cases = [(1.0, 1.0 + 1e-7), (1.0, 2.0), (0.0, 0.0), (5.0, 5.0 - 1e-4)]
    for cost, old in cases:
        assert ts.EpsTermination().terminate(cost, old) == \
            js.EpsTermination().terminate(cost, old)
    assert ts.Norm2Termination(1e-3).terminate(0, 0, 1e-4)
    assert not ts.Norm2Termination(1e-3).terminate(0, 0, 1e-2)
    assert not ts.Norm2Termination().terminate(0, 0, None)
    assert ts.ZeroDirection().terminate(0, 0, 0.0)
    assert not ts.ZeroDirection().terminate(0, 0, 1.0)


def test_line_search_refuses_an_ascent_direction():
    import torch

    ls = ts.BackTrackLineSearch(lambda v: float((v * v).sum()))
    x = torch.tensor([1.0, 2.0], dtype=torch.float64)
    g = 2 * x
    assert ls.optimize(x, 5.0, g, g) == 0.0
    assert ls.optimize(x, 5.0, g, -g) == pytest.approx(0.5)


# -------------------------------------------- test_gradients.py counterparts
def _build(layers, input_type, seed=42, l1=0.0, l2=0.0):
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.updater import Sgd

    lb = (NeuralNetConfiguration.builder().seed(seed)
          .updater(Sgd(learning_rate=0.1)).weight_init("xavier")
          .dtype("float64").l1(l1).l2(l2).list(*layers))
    if input_type is not None:
        lb = lb.set_input_type(input_type)
    return MultiLayerNetwork(lb.build()).init(device="cpu")


def _onehot(rng, n, c):
    return np.eye(c)[rng.integers(0, c, n)]


def _gradient_cases():
    from deeplearning4j_torch.nn.conf.inputs import InputType as I
    from deeplearning4j_torch.nn.conf import layers as L

    def ff(seed, n, f, c):
        rng = np.random.default_rng(seed)
        return rng.normal(0, 1, (n, f)), _onehot(rng, n, c)

    def img(seed, n, h, ch, c):
        rng = np.random.default_rng(seed)
        return rng.normal(0, 1, (n, h, h, ch)), _onehot(rng, n, c)

    def seq(seed, n, t, f, c):
        rng = np.random.default_rng(seed)
        return (rng.normal(0, 1, (n, t, f)),
                np.eye(c)[rng.integers(0, c, (n, t))])

    def dense_out(n_out=3):
        return L.OutputLayer(n_out=n_out, loss="mcxent",
                             activation="softmax")

    cases = {
        "mlp": lambda: (_build([L.DenseLayer(n_out=6, activation="tanh"),
                                L.DenseLayer(n_out=5,
                                             activation="softplus"),
                                dense_out()], I.feed_forward(4)),
                        *ff(0, 5, 4, 3), {}),
        "mlp_l1_l2": lambda: (_build([L.DenseLayer(n_out=6,
                                                   activation="tanh"),
                                      dense_out()], I.feed_forward(4),
                                     l1=0.01, l2=0.02), *ff(1, 5, 4, 3), {}),
        "cnn": lambda: (_build([L.ConvolutionLayer(
            n_out=3, kernel_size=(2, 2), stride=(1, 1), activation="tanh"),
            L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                               stride=(2, 2)), dense_out(2)],
            I.convolutional(6, 6, 2)), *img(3, 3, 6, 2, 2), {}),
        "cnn_avg_same": lambda: (_build([L.ConvolutionLayer(
            n_out=2, kernel_size=(3, 3), stride=(1, 1),
            convolution_mode="same", activation="softplus"),
            L.SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2),
                               stride=(2, 2), convolution_mode="same"),
            L.ZeroPaddingLayer(pad_top=1, pad_bottom=1, pad_left=1,
                               pad_right=1), dense_out(2)],
            I.convolutional(5, 5, 1)), *img(4, 3, 5, 1, 2), {}),
        "batchnorm": lambda: (_build([L.DenseLayer(n_out=5,
                                                   activation="tanh"),
                                      L.BatchNormalization(), dense_out()],
                                     I.feed_forward(4)), *ff(5, 6, 4, 3),
                              {}),
        "layernorm": lambda: (_build([L.DenseLayer(n_out=5,
                                                   activation="tanh"),
                                      L.LayerNormalization(), dense_out()],
                                     I.feed_forward(4)), *ff(15, 6, 4, 3),
                              {}),
        "layernorm_seq": lambda: (_build([
            L.PositionalEncodingLayer(), L.SimpleRnn(n_out=5,
                                                     activation="tanh"),
            L.LayerNormalization(), L.RnnOutputLayer(
                n_out=2, loss="mcxent", activation="softmax")],
            I.recurrent(3, 4)), np.random.default_rng(16).normal(
                0, 1, (2, 4, 3)), np.eye(2)[np.zeros((2, 4), int)], {}),
        "lrn": lambda: (_build([L.ConvolutionLayer(
            n_out=4, kernel_size=(2, 2), activation="tanh"),
            L.LocalResponseNormalization(), dense_out(2)],
            I.convolutional(4, 4, 1)), *img(6, 2, 4, 1, 2), {}),
        "bidirectional_lstm": lambda: (_build([
            L.GravesBidirectionalLSTM(n_out=3, activation="tanh"),
            L.RnnOutputLayer(n_out=2, loss="mcxent", activation="softmax")],
            I.recurrent(3)), *seq(8, 2, 4, 3, 2), {}),
        "global_pooling": lambda: (_build([
            L.GravesLSTM(n_out=4, activation="tanh"),
            L.GlobalPoolingLayer(pooling_type="avg"), dense_out(2)],
            I.recurrent(3)), np.random.default_rng(10).normal(
                0, 1, (2, 4, 3)), _onehot(np.random.default_rng(11), 2, 2),
            {}),
        "cnn_global_pooling": lambda: (_build([L.ConvolutionLayer(
            n_out=3, kernel_size=(2, 2), activation="tanh"),
            L.GlobalPoolingLayer(pooling_type="max"), dense_out(2)],
            I.convolutional(5, 5, 1)), *img(11, 2, 5, 1, 2), {}),
        "embedding": lambda: (_build([L.EmbeddingLayer(
            n_in=7, n_out=4, activation="tanh"), L.OutputLayer(
            n_in=4, n_out=3, loss="mcxent", activation="softmax")], None),
            np.random.default_rng(12).integers(0, 7, (5, 1)).astype(float),
            _onehot(np.random.default_rng(13), 5, 3), {}),
        "bn_global_l2": lambda: (_build([L.DenseLayer(n_out=6,
                                                      activation="tanh"),
                                         L.BatchNormalization(),
                                         dense_out()], I.feed_forward(4),
                                        l1=0.01, l2=0.02),
                                 *ff(4, 6, 4, 3), dict(train=False)),
    }
    for name in ("LSTM", "GravesLSTM", "SimpleRnn"):
        cases[f"rnn_{name}"] = (lambda name=name: (_build([
            getattr(L, name)(n_out=4, activation="tanh"),
            L.RnnOutputLayer(n_out=3, loss="mcxent", activation="softmax")],
            I.recurrent(3)), *seq(7, 2, 5, 3, 3), {}))
    for loss, act in (("mse", "identity"), ("xent", "sigmoid"),
                      ("mean_absolute_error", "tanh"),
                      ("negativeloglikelihood", "softmax")):
        def case(loss=loss, act=act):
            rng = np.random.default_rng(2)
            net = _build([L.DenseLayer(n_out=5, activation="tanh"),
                          L.OutputLayer(n_out=3, loss=loss,
                                        activation=act)],
                         I.feed_forward(4))
            x = rng.normal(0, 1, (4, 4))
            if loss == "xent":
                y = (rng.random((4, 3)) > 0.5).astype(float)
            elif act == "softmax":
                y = _onehot(rng, 4, 3)
            else:
                y = rng.normal(0, 1, (4, 3))
            return net, x, y, {}
        cases[f"loss_{loss}"] = case
    return cases


@pytest.mark.parametrize("name", sorted(_gradient_cases()))
def test_gradient_check(name):
    net, x, y, kw = _gradient_cases()[name]()
    assert check_gradients(net, x, y, **kw)


def test_lstm_masking_gradients():
    """Masked time steps contribute zero gradient."""
    from deeplearning4j_torch.nn.conf.inputs import InputType as I
    from deeplearning4j_torch.nn.conf import layers as L

    rng = np.random.default_rng(9)
    net = _build([L.GravesLSTM(n_out=4, activation="tanh"),
                  L.RnnOutputLayer(n_out=2, loss="mcxent",
                                   activation="softmax")], I.recurrent(3))
    x = rng.normal(0, 1, (3, 5, 3))
    y = np.eye(2)[rng.integers(0, 2, (3, 5))]
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 0, 0, 0, 0]],
                    float)
    assert check_gradients(net, x, y, input_mask=mask, label_mask=mask)


def test_gradient_check_catches_a_wrong_gradient(monkeypatch):
    """A layer whose backward is wrong fails the check (a doubled tanh
    derivative through an autograd hook)."""
    from deeplearning4j_torch.nn.conf.inputs import InputType as I
    from deeplearning4j_torch.nn.conf import layers as L

    net = _build([L.DenseLayer(n_out=4, activation="identity"),
                  L.OutputLayer(n_out=2, loss="mse",
                                activation="identity")], I.feed_forward(3))
    rng = np.random.default_rng(1)
    x, y = rng.normal(0, 1, (4, 3)), rng.normal(0, 1, (4, 2))
    assert check_gradients(net, x, y)
    orig = L.DenseLayer.preactivate

    def doubled(self, params, xx):
        out = orig(self, params, xx)
        if out.requires_grad:
            out.register_hook(lambda g: 2 * g)
        return out

    monkeypatch.setattr(L.DenseLayer, "preactivate", doubled)
    assert not check_gradients(net, x, y)
