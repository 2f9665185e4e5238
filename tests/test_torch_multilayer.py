"""The port's MultiLayerNetwork against the JAX package's
(``nn/multilayer.py`` and the modules it drives) on the CPU, at small
sizes, on the JAX nets' own weights (``params_from_jax``):

- ``zoo.LeNet``: ``output()`` within 1e-5, the loss within rtol 1e-5 and
  the first-step gradients within 1e-5 of each leaf's max|g|; eight
  AdaDelta ``do_step``s to params within rtol 1e-5 + 1e-5·max|p|;
- ``fit`` at its defaults equal to ``fit(fused_steps=1)`` bit for bit with
  a NaN batch skipped, and skipped as the JAX package skips it;
- input dropout and stochastic preprocessors: masks and samples equal to
  JAX's bit for bit, and the training loss and gradients through them;
- ``SimpleCNN`` at 16×16×1 (batch norm, average pooling, dropout);
- every preprocessor; the ``CenterLossOutputLayer`` center update; a
  ComputationGraph whose vertices carry preprocessors; ``rnn_time_step``
  over causal attention;
- AlexNet, VGG16 and VGG19 parameter counts and output shapes at the JAX
  zoo test's sizes; int8 LeNet at JAX's eval-parity rule, its codes and
  scales equal to JAX's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.models import zoo as tzoo
from deeplearning4j_torch.nn.conf import preprocessors as tpp
from deeplearning4j_torch.ops import random as trandom
from deeplearning4j_torch.optimize.fused_fit import value_and_grad
from deeplearning4j_torch.utils.convert import params_from_jax
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import preprocessors as jpp

pytestmark = pytest.mark.torch_port

FWD_ATOL = 1e-5
RTOL = 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_init(jconf):
    """The JAX MultiLayerNetwork of ``jconf`` with its weights drawn as its
    ``init`` draws them, in one jitted program (the JAX package's own
    ``run_fused_on_tpu`` path; the same values as the eager draw, in a
    fraction of the CPU time)."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    dtype = jnp.dtype(jconf.dtype)
    keys = jax.random.split(jax.random.PRNGKey(jconf.seed),
                            len(jconf.layers))
    params = jax.jit(lambda ks: {str(i): la.init_params(ks[i], dtype)
                                 for i, la in enumerate(jconf.layers)})(keys)
    return MultiLayerNetwork(jconf).init(params)


def _pair(name, **kw):
    """The JAX and the port zoo model ``name``, the port on the JAX net's
    weights."""
    jnet = _jax_init(getattr(jzoo, name)(**kw).conf())
    net = getattr(tzoo, name)(**kw).init(device="cpu")
    params_from_jax(_host(jnet.params), net)
    return jnet, net


def _assert_tree_close(got, want, rule, what):
    """``rule="grad"``: within RTOL of max|g| per leaf; ``"param"``: within
    rtol RTOL plus RTOL·max|p| per leaf."""
    for key, leaves in want.items():
        for k, w in leaves.items():
            w = np.asarray(w)
            g = got[key][k].detach().cpu().numpy()
            scale = float(np.abs(w).max()) if w.size else 0.0
            if rule == "grad":
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=RTOL * max(scale, 1e-30),
                                           err_msg=f"{what} {key}/{k}")
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL,
                                           atol=RTOL * scale,
                                           err_msg=f"{what} {key}/{k}")


def _batch(shape, classes, n, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rs.randint(0, classes, n)]
    return x, y


def _loss_and_grads(jnet, net, x, y, train=False, seed=None):
    jkey = None if seed is None else jax.random.PRNGKey(seed)
    tkey = None if seed is None else trandom.PRNGKey(seed, device="cpu")
    (jl, (jstates, _, _)), jg = jax.jit(jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                             None, None, train=train, rng=jkey),
        has_aux=True))(jnet.params)
    tl, tg = value_and_grad(net, net.params, net.state, torch.from_numpy(x),
                            torch.from_numpy(y), train=train, rng=tkey)
    return (float(jl), _host(jg), _host(jstates)), (float(tl), tg)


# ------------------------------------------------------------------ LeNet
@pytest.fixture(scope="module")
def lenet_pair():
    return _pair("LeNet", seed=3)


def test_lenet_output_loss_and_grads_match_jax(lenet_pair):
    jnet, net = lenet_pair
    x, y = _batch((28, 28, 1), 10, 6, seed=1)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=FWD_ATOL,
                               rtol=0)
    (jl, jg, _), (tl, tg) = _loss_and_grads(jnet, net, x, y, train=True)
    assert abs(tl - jl) <= RTOL * abs(jl)
    _assert_tree_close(tg, jg, "grad", "LeNet first-step gradient")
    assert abs(net.score(x=x, y=y) - jnet.score(x=x, y=y)) <= RTOL * abs(jl)


def test_lenet_eight_adadelta_steps_match_jax():
    jnet, net = _pair("LeNet", seed=3)
    for i in range(8):
        x, y = _batch((28, 28, 1), 10, 8, seed=10 + i)
        jnet.do_step(x, y)
        net.do_step(x, y)
    assert net.iteration == jnet.iteration == 8
    _assert_tree_close(net.params, _host(jnet.params), "param",
                       "LeNet after 8 AdaDelta steps")


def _nan_stream():
    """Seven batches of four 12×12 images, the fourth one NaN."""
    out = []
    for i in range(7):
        x, y = _batch((12, 12, 1), 10, 4, seed=40 + i)
        if i == 3:
            x[1, 2, 3, 0] = np.nan
        out.append((x, y))
    return out


def test_fit_defaults_equal_unfused_and_skip_the_nan_batch_as_jax():
    """``fit`` at its defaults (K = 2 on the CPU, the health guard on)
    equals ``fit(fused_steps=1)`` bit for bit, both skip the one NaN
    batch, and the JAX package's ``fit`` skips it too and lands within
    rtol 1e-5 + 1e-5·max|p|."""
    from deeplearning4j_torch.optimize.health import HealthPolicy
    from deeplearning4j_tpu.optimize.health import HealthPolicy as JPolicy

    stream = _nan_stream()
    jnet = jzoo.LeNet(seed=5, input_shape=(12, 12, 1)).init()
    nets, skips = [], []
    for K in (None, 1):
        net = tzoo.LeNet(seed=5, input_shape=(12, 12, 1)).init(device="cpu")
        params_from_jax(_host(jnet.params), net)
        policy = HealthPolicy()
        net.fit([DataSet(x, y) for x, y in stream], fused_steps=K,
                health_guard=policy)
        nets.append(net)
        skips.append(policy.total_skips)
    jpolicy = JPolicy()
    jnet.fit([JDataSet(x, y) for x, y in stream], health_guard=jpolicy)
    assert skips == [1, 1] and jpolicy.total_skips == 1
    assert nets[0].iteration == nets[1].iteration == jnet.iteration == 7
    for key, leaves in nets[0].params.items():
        for k, t in leaves.items():
            assert torch.equal(t, nets[1].params[key][k]), (key, k)
    _assert_tree_close(nets[0].params, _host(jnet.params), "param",
                       "fit with a NaN batch")


# ---------------------------------------------- dropout and preprocessors
def _stochastic_conf(pkg):
    """Input dropout on three layers, a Bernoulli preprocessor before the
    first and a composed (zero-mean, Bernoulli) one before the head."""
    import importlib

    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
    pp = importlib.import_module(f"{pkg}.nn.conf.preprocessors")
    upd = importlib.import_module(f"{pkg}.nn.updater")
    inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
    return (b.NeuralNetConfiguration.builder().seed(11)
            .updater(upd.Sgd(learning_rate=0.1))
            .list(core.DropoutLayer(dropout=0.5),
                  core.DenseLayer(n_out=7, activation="tanh", dropout=0.3),
                  core.DropoutLayer(dropout=0.25),
                  core.OutputLayer(n_out=3, activation="softmax"))
            .input_pre_processor(0, pp.BinomialSamplingPreProcessor(seed=9))
            .input_pre_processor(3, pp.ComposableInputPreProcessor(
                [pp.ZeroMeanPrePreProcessor(),
                 pp.BinomialSamplingPreProcessor(seed=2)]))
            .set_input_type(inputs.InputType.feed_forward(6)).build())


def test_dropout_and_preprocessor_draws_equal_jax():
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.nn.multilayer import (
        MultiLayerNetwork as JMultiLayerNetwork)

    jnet = JMultiLayerNetwork(_stochastic_conf("deeplearning4j_tpu")).init()
    net = MultiLayerNetwork(_stochastic_conf("deeplearning4j_torch")).init(
        device="cpu")
    params_from_jax(_host(jnet.params), net)
    x, y = _batch((6,), 3, 16, seed=7)
    for it in range(3):
        jk = jax.random.fold_in(jax.random.PRNGKey(11), it)
        tk = trandom.fold_in(trandom.PRNGKey(11, device="cpu"), it)
        # layer 0: dropout of the Bernoulli sample, values 0 or 2 exactly
        j0 = np.asarray(jnet._forward(jnet.params, jnet.state,
                                      jnp.asarray(x), None, train=True,
                                      rng=jk, upto=1)[0])
        t0 = net._forward(net.params, net.state, torch.from_numpy(x), None,
                          train=True, rng=tk, upto=1)[0].numpy()
        np.testing.assert_array_equal(t0, j0)
        assert 0 < np.count_nonzero(t0) < t0.size
        j3 = np.asarray(jnet._forward(jnet.params, jnet.state,
                                      jnp.asarray(x), None, train=True,
                                      rng=jk, upto=3)[0])
        t3 = net._forward(net.params, net.state, torch.from_numpy(x), None,
                          train=True, rng=tk, upto=3)[0].numpy()
        np.testing.assert_array_equal(t3 == 0, j3 == 0)
        np.testing.assert_allclose(t3, j3, atol=1e-6, rtol=0)
    (jl, jg, _), (tl, tg) = _loss_and_grads(jnet, net, x, y, train=True,
                                            seed=4)
    assert abs(tl - jl) <= RTOL * abs(jl)
    _assert_tree_close(tg, jg, "grad", "stochastic MLN gradient")
    jnet.do_step(x, y)
    net.do_step(x, y)
    _assert_tree_close(net.params, _host(jnet.params), "param",
                       "stochastic MLN step")


def test_simplecnn_16x16_matches_jax():
    """SimpleCNN at 16×16×1: batch norm in training (its new running
    statistics), average pooling, dropout 0.5 keyed as JAX's; the output,
    the loss and the gradients. In f64, so that the comparison reads the
    arithmetic and not the two libraries' f32 reduction orders, which
    nine training-mode batch norms over maps as small as 2×2 amplify. A
    convolution's bias in front of a training-mode batch norm has an exact
    gradient of 0 (the batch mean takes it out), so both packages' values
    for those leaves are rounding noise: they are held to 1e-5 of the
    largest gradient of the net, the other leaves to 1e-5 of their own."""
    from deeplearning4j_torch.nn.conf.layers.normalization import (
        BatchNormalization)

    jnet, net = _pair("SimpleCNN", seed=2, input_shape=(16, 16, 1),
                      dtype="float64")
    x, y = (a.astype(np.float64) for a in _batch((16, 16, 1), 10, 4,
                                                 seed=3))
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=FWD_ATOL,
                               rtol=0)
    (jl, jg, jst), (tl, tg) = _loss_and_grads(jnet, net, x, y, train=True,
                                              seed=8)
    assert abs(tl - jl) <= RTOL * abs(jl)
    zero = {str(i) for i, la in enumerate(net.layers[:-1])
            if isinstance(net.layers[i + 1], BatchNormalization)
            and "b" in net.params[str(i)]}
    assert len(zero) == 9
    top = max(float(np.abs(v).max()) for p in jg.values() for v in p.values())
    for key in zero:
        for g in (jg[key].pop("b"), tg[key].pop("b").numpy()):
            assert float(np.abs(g).max()) <= RTOL * top
    _assert_tree_close(tg, jg, "grad", "SimpleCNN gradient")
    for key, st in jst.items():
        for k, v in st.items():
            np.testing.assert_allclose(
                net._loss(net.params, net.state, torch.from_numpy(x),
                          torch.from_numpy(y), None, None, train=True,
                          rng=trandom.PRNGKey(8, device="cpu"))[1][0][key][k]
                .detach().numpy(), v, atol=1e-6, rtol=0)


_PREPROCESSORS = {
    "CnnToFeedForwardPreProcessor": (dict(height=4, width=5, channels=3),
                                     (2, 4, 5, 3), ("convolutional", 4, 5,
                                                    3)),
    "FeedForwardToCnnPreProcessor": (dict(height=4, width=5, channels=3),
                                     (2, 60), ("feed_forward", 60)),
    "ZeroMeanPrePreProcessor": (dict(), (8, 5), ("feed_forward", 5)),
    "UnitVarianceProcessor": (dict(), (8, 5), ("feed_forward", 5)),
    "ZeroMeanAndUnitVariancePreProcessor": (dict(), (16, 4),
                                            ("feed_forward", 4)),
    "BinomialSamplingPreProcessor": (dict(seed=3), (6, 9),
                                     ("feed_forward", 9)),
    "ComposableInputPreProcessor": (None, (6, 9), ("feed_forward", 9)),
    "RnnToFeedForwardPreProcessor": (dict(), (2, 7, 5), ("recurrent", 5)),
    "FeedForwardToRnnPreProcessor": (dict(), (3, 6), ("feed_forward", 6)),
    "CnnToRnnPreProcessor": (dict(height=4, width=5, channels=3),
                             (2, 4, 5, 3), ("convolutional", 4, 5, 3)),
    "RnnToCnnPreProcessor": (dict(height=4, width=5, channels=3),
                             (2, 20, 3), ("recurrent", 3)),
}


def _make_pp(mod, name, fields):
    if name == "ComposableInputPreProcessor":
        return mod.ComposableInputPreProcessor(
            [mod.ZeroMeanAndUnitVariancePreProcessor(),
             mod.BinomialSamplingPreProcessor(seed=1),
             mod.ZeroMeanPrePreProcessor()])
    return getattr(mod, name)(**fields)


@pytest.mark.parametrize("name", sorted(_PREPROCESSORS))
def test_preprocessor_matches_jax(name):
    """Forward (with and without a key), its gradient and its output
    type, against the JAX preprocessor of the same name and fields."""
    from deeplearning4j_torch.nn.conf.inputs import InputType as TIT
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT

    fields, shape, (kind, *dims) = _PREPROCESSORS[name]
    jp, tp = _make_pp(jpp, name, fields), _make_pp(tpp, name, fields)
    rs = np.random.RandomState(len(name))
    x = rs.rand(*shape).astype(np.float32) * 3
    if "Binomial" in name or "Composable" in name:
        x = x / 3
    for jk, tk in ((None, None),
                   (jax.random.PRNGKey(5), trandom.PRNGKey(5,
                                                           device="cpu"))):
        want = np.asarray(jp.forward(jnp.asarray(x), rng=jk))
        got = tp.forward(torch.from_numpy(x), rng=tk).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    R = rs.randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jp.forward(a) * R))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tp.forward(tx) * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=0)
    jt = (getattr(JIT, kind)(*dims))
    tt = (getattr(TIT, kind)(*dims))
    assert vars(tp.output_type(tt)) == vars(jp.output_type(jt))


def test_center_loss_step_matches_jax():
    """A Dense + ``CenterLossOutputLayer`` net: three Sgd steps move the
    class centers (layer state, outside the gradient) and the params as
    the JAX package's do."""
    import importlib

    nets = []
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_torch"):
        b = importlib.import_module(f"{pkg}.nn.conf.builders")
        core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
        misc = importlib.import_module(f"{pkg}.nn.conf.layers.misc")
        upd = importlib.import_module(f"{pkg}.nn.updater")
        inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
        mln = importlib.import_module(f"{pkg}.nn.multilayer")
        conf = (b.NeuralNetConfiguration.builder().seed(1)
                .updater(upd.Sgd(learning_rate=0.2))
                .list(core.DenseLayer(n_out=4, activation="tanh"),
                      misc.CenterLossOutputLayer(n_out=3, alpha=0.3,
                                                 lambda_=0.5))
                .set_input_type(inputs.InputType.feed_forward(5)).build())
        nets.append(mln.MultiLayerNetwork(conf))
    jnet = nets[0].init()
    net = nets[1].init(device="cpu")
    params_from_jax(_host(jnet.params), net)
    for i in range(3):
        x, y = _batch((5,), 3, 8, seed=20 + i)
        jnet.do_step(x, y)
        net.do_step(x, y)
    centers = np.asarray(jnet.state["1"]["centers"])
    assert np.abs(centers).max() > 0
    np.testing.assert_allclose(net.state["1"]["centers"].numpy(), centers,
                               atol=1e-6, rtol=0)
    _assert_tree_close(net.params, _host(jnet.params), "param",
                       "center-loss steps")


# ------------------------------------------------------ larger zoo models
@pytest.mark.parametrize("name,shape", [("AlexNet", (224, 224, 3)),
                                        ("VGG16", (32, 32, 3)),
                                        ("VGG19", (32, 32, 3))])
def test_big_zoo_models_count_and_shape(name, shape):
    """The JAX zoo test's sizes: the parameter count equals the JAX
    model's (shapes from ``jax.eval_shape``, nothing drawn), and a
    train-mode ``output`` of two images is a finite softmax."""
    jconf = getattr(jzoo, name)(num_labels=10, input_shape=shape).conf()
    shapes = jax.eval_shape(
        lambda k: [la.init_params(k) for la in jconf.layers],
        jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    net = getattr(tzoo, name)(num_labels=10, input_shape=shape).init(
        device="cpu")
    assert net.num_params() == want
    x = np.random.RandomState(1).randn(2, *shape).astype(np.float32)
    out = net.output(x, train=True).numpy()
    assert out.shape == (2, 10) and np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-4)


def test_int8_lenet_eval_parity_and_codes_equal_jax(lenet_pair):
    """JAX's ``test_lenet_eval_parity`` rule on the port (confusion delta
    <= 0.05, outputs within 5e-2 of the f32 net's), with the int8 codes
    and scales equal to the JAX package's bit for bit."""
    from deeplearning4j_torch.optimize.quantize import (confusion_delta,
                                                        quantize_net)
    from deeplearning4j_tpu.optimize.quantize import (
        quantize_net as jquantize_net)

    jnet, net = lenet_pair
    qnet = quantize_net(net)
    jq = _host(jquantize_net(jnet).params)
    for key, leaves in jq.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(qnet.params[key][k].numpy(), v)
    assert qnet.params["0"]["W"].dtype == torch.int8
    rs = np.random.RandomState(2)
    x = rs.randn(64, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 64)]
    ev_f = net.evaluate(DataSet(x, y))
    ev_q = qnet.evaluate(DataSet(x, y))
    assert confusion_delta(ev_f, ev_q) <= 0.05
    np.testing.assert_allclose(qnet.output(x).numpy(), net.output(x).numpy(),
                               atol=5e-2)
    q = tzoo.LeNet(seed=1, quantize="int8").init(device="cpu")
    assert q.params["2"]["W"].dtype == torch.int8 and "W_scale" in \
        q.params["2"]


def test_multilayer_plumbing():
    """``output`` pads a batch to a power of two and cuts the padding
    (rows equal to an unpadded call's), ``feed_forward`` lists every
    activation, ``params_flat``/``set_params_flat`` round-trip, ``clone``
    copies, and ``pretrain`` of a net with no pretrain layer leaves its
    parameters as they were."""
    net = tzoo.LeNet(seed=1, input_shape=(12, 12, 1)).init(device="cpu")
    x, y = _batch((12, 12, 1), 10, 3, seed=9)
    out3 = net.output(x)
    assert out3.shape == (3, 10)
    np.testing.assert_allclose(net.output(x[:2]).numpy(), out3[:2].numpy(),
                               atol=1e-6)
    acts = net.feed_forward(x)
    assert len(acts) == len(net.layers) + 1
    torch.testing.assert_close(acts[-1], out3)
    flat = net.params_flat()
    assert flat.size == net.num_params()
    twin = net.clone()
    net.do_step(x, y)
    assert not np.array_equal(net.params_flat(), flat)
    np.testing.assert_array_equal(twin.params_flat(), flat)
    twin.set_params_flat(net.params_flat())
    torch.testing.assert_close(twin.output(x), net.output(x))
    # LeNet has no pretrain layer: pretrain returns the net untouched, as
    # JAX's does
    before = net.params_flat()
    assert net.pretrain([DataSet(x, y)]) is net
    np.testing.assert_array_equal(net.params_flat(), before)
    # an unguarded step leaves batch norm's statistics out of autograd
    bn = tzoo.SimpleCNN(input_shape=(16, 16, 1)).init(device="cpu")
    bn.do_step(*_batch((16, 16, 1), 10, 2, seed=1))
    assert not any(t.requires_grad for st in bn.state.values()
                   for t in st.values())


def _graph_conf(pkg):
    """A graph over a flat image input: the builder inserts the
    FeedForwardToCnn preprocessor before the convolution vertex and the
    CnnToFeedForward one before the dense head; a batch norm vertex keeps
    running statistics."""
    import importlib

    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    conv = importlib.import_module(f"{pkg}.nn.conf.layers.convolution")
    core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
    norm = importlib.import_module(f"{pkg}.nn.conf.layers.normalization")
    upd = importlib.import_module(f"{pkg}.nn.updater")
    inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
    g = (b.NeuralNetConfiguration.builder().seed(6)
         .updater(upd.Sgd(learning_rate=0.1)).graph_builder()
         .add_inputs("in")
         .set_input_types(inputs.InputType.convolutional_flat(8, 8, 1)))
    g.add_layer("conv", conv.ConvolutionLayer(n_out=3, kernel_size=3,
                                              activation="relu"), "in")
    g.add_layer("bn", norm.BatchNormalization(), "conv")
    g.add_layer("pool", conv.SubsamplingLayer(), "bn")
    g.add_layer("out", core.OutputLayer(n_out=4), "pool")
    return g.set_outputs("out").build()


def test_graph_vertex_preprocessors_match_jax():
    """A ComputationGraph's vertex preprocessors (inserted by the build,
    as JAX inserts them) act: the same JSON as the JAX build, the output,
    the loss and gradients, and one step with batch norm's running
    statistics, against JAX's graph."""
    import json

    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraph as JComputationGraph)
    from deeplearning4j_tpu.utils import serde as jserde

    jconf, tconf = (_graph_conf("deeplearning4j_tpu"),
                    _graph_conf("deeplearning4j_torch"))
    assert json.loads(tconf.to_json()) == json.loads(jserde.to_json(jconf))
    assert type(tconf.vertices["conv"].preprocessor).__name__ == \
        "FeedForwardToCnnPreProcessor"
    jnet = JComputationGraph(jconf).init()
    net = ComputationGraph(tconf).init(device="cpu")
    params_from_jax(_host(jnet.params), net)
    x, y = _batch((64,), 4, 5, seed=12)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=FWD_ATOL,
                               rtol=0)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, [jnp.asarray(x)],
                             [jnp.asarray(y)], None, None, train=True,
                             rng=None), has_aux=True)(jnet.params)
    tl, tg = value_and_grad(net, net.params, net.state,
                            [torch.from_numpy(x)], [torch.from_numpy(y)],
                            train=True)
    assert abs(float(tl) - float(jl)) <= RTOL * abs(float(jl))
    _assert_tree_close(tg, _host(jg), "grad", "graph gradient")
    jnet.do_step(x, y)
    net.do_step(x, y)
    _assert_tree_close(net.params, _host(jnet.params), "param",
                       "graph step")
    for k in ("mean", "var"):
        np.testing.assert_allclose(net.state["bn"][k].numpy(),
                                   np.asarray(jnet.state["bn"][k]),
                                   atol=1e-6, rtol=0)


def test_rnn_time_step_streams_as_jax():
    """A MultiLayerNetwork over sequences (Dense, positions, causal
    attention, a per-step head) streams through ``rnn_time_step`` to the
    JAX package's outputs, chunk by chunk, and to its own ``output()``."""
    import importlib

    nets = []
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_torch"):
        b = importlib.import_module(f"{pkg}.nn.conf.builders")
        core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
        att = importlib.import_module(f"{pkg}.nn.conf.layers.attention")
        rec = importlib.import_module(f"{pkg}.nn.conf.layers.recurrent")
        inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
        mln = importlib.import_module(f"{pkg}.nn.multilayer")
        conf = (b.NeuralNetConfiguration.builder().seed(2)
                .list(core.DenseLayer(n_out=8, activation="identity"),
                      att.PositionalEncodingLayer(),
                      att.SelfAttentionLayer(n_heads=2, causal=True,
                                             max_cache=16),
                      rec.RnnOutputLayer(n_out=5, activation="softmax"))
                .set_input_type(inputs.InputType.recurrent(6, 9)).build())
        nets.append(mln.MultiLayerNetwork(conf))
    jnet = nets[0].init()
    net = nets[1].init(device="cpu")
    params_from_jax(_host(jnet.params), net)
    x = np.random.RandomState(3).rand(2, 9, 6).astype(np.float32)
    full = net.output(x).numpy()
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)),
                               atol=FWD_ATOL, rtol=0)
    got = []
    for lo, hi in ((0, 4), (4, 5), (5, 9)):
        step = x[:, lo] if hi - lo == 1 else x[:, lo:hi]
        t = net.rnn_time_step(step).numpy()
        np.testing.assert_allclose(t, np.asarray(jnet.rnn_time_step(step)),
                                   atol=FWD_ATOL, rtol=0)
        got.append(t[:, None] if t.ndim == 2 else t)
    np.testing.assert_allclose(np.concatenate(got, axis=1), full,
                               atol=FWD_ATOL, rtol=0)
