"""The port's ``MixtureOfExpertsLayer`` (``nn/conf/layers/moe.py``) and
``nn/simple.py`` against the JAX package's on the CPU:

- the counterparts of ``tests/test_moe.py`` (top-k sparsity and
  normalization, exact top-k under ties, top-1 as the argmax expert, the
  full softmax at ``top_k == n_experts``, the f64 gradient check, learning
  a partitioned function, serde, validation) and of
  ``tests/test_gradients.py::test_moe_load_balance_term_trains``;
- parity on the JAX net's weights: gates, outputs (f32 within 1e-5 of
  max|y|), the selected experts equal, f64 loss gradients within 1e-10 of
  each leaf's max|g| with the load-balance term on, two Adam steps;
- the tie case: all-equal logits (a zero token) select the same two
  lowest-index experts as ``lax.top_k``, and so do partly tied rows;
- a JAX MoE zip loads in the port and the port's in JAX;
- ``RankClassificationResult`` and ``BinaryClassificationResult`` equal
  the JAX package's on the same probabilities, tensors included.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.nn.conf.layers import MixtureOfExpertsLayer
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.utils.convert import params_from_jax
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork)
from deeplearning4j_tpu.utils import serde as jserde

pytestmark = pytest.mark.torch_port


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _conf(pkg, top_k=2, n_experts=4, lb=0.0, dtype=None, seed=2):
    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    layers = importlib.import_module(f"{pkg}.nn.conf.layers")
    inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
    upd = importlib.import_module(f"{pkg}.nn.updater")
    nb = b.NeuralNetConfiguration.builder().seed(seed).updater(
        upd.Adam(learning_rate=0.01))
    if dtype:
        nb = nb.dtype(dtype)
    return (nb.list(layers.MixtureOfExpertsLayer(
        n_out=16, n_experts=n_experts, top_k=top_k, expert_hidden=24,
        load_balance_coef=lb),
        layers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(inputs.InputType.feed_forward(6)).build())


def _net(**kw):
    return MultiLayerNetwork(_conf("deeplearning4j_torch", **kw)).init(
        device="cpu")


def _pair(**kw):
    """The port net, and the JAX net on its weights (JSON equal)."""
    tconf = _conf("deeplearning4j_torch", **kw)
    jconf = _conf("deeplearning4j_tpu", **kw)
    assert json.loads(tconf.to_json()) == json.loads(jserde.to_json(jconf))
    net = MultiLayerNetwork(tconf).init(device="cpu")
    jnet = JMultiLayerNetwork(jconf).init(jax.tree_util.tree_map(
        jnp.asarray, {v: {k: t.numpy() for k, t in p.items()}
                      for v, p in net.params.items()}))
    return jnet, net


# ------------------------------------------------- test_moe.py counterparts
def test_topk_gates_sparse_normalized_and_exact_under_ties():
    net = _net(top_k=2, n_experts=5)
    layer = net.layers[0]
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 6)
                         .astype(np.float32))
    gates = layer._gate(net.params["0"], x).numpy()
    assert gates.shape == (8, 5)
    assert ((gates > 0).sum(axis=1) <= 2).all()
    np.testing.assert_allclose(gates.sum(axis=1), 1.0, atol=1e-6)
    zgates = layer._gate(net.params["0"], torch.zeros((1, 6))).numpy()
    assert (zgates > 0).sum() == 2


def test_top1_equals_argmax_expert():
    net = _net(top_k=1, n_experts=3)
    p = {k: t.numpy() for k, t in net.params["0"].items()}
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    out, _ = net.layers[0].forward(net.params["0"], {}, torch.from_numpy(x))
    pick = np.argmax(x @ p["Wg"], axis=1)
    h = np.maximum(np.einsum("bd,edh->beh", x, p["W1"]) + p["b1"], 0)
    y = np.einsum("beh,eho->beo", h, p["W2"]) + p["b2"]
    np.testing.assert_allclose(out.numpy(), y[np.arange(4), pick], atol=1e-5)


def test_full_softmax_when_topk_equals_experts():
    net = _net(top_k=4, n_experts=4)
    out = net.output(np.random.RandomState(2).randn(5, 6).astype(np.float32))
    assert tuple(out.shape) == (5, 3)


def test_gradcheck_through_moe():
    """top_k == n_experts keeps the layer smooth, so central differences
    hold every einsum, FFN and gate gradient (as JAX's test runs it)."""
    from deeplearning4j_torch.gradientcheck import check_gradients

    net = _net(top_k=4, n_experts=4, dtype="float64")
    rs = np.random.RandomState(3)
    x = rs.randn(4, 6)
    y = np.eye(3)[rs.randint(0, 3, 4)]
    assert check_gradients(net, x, y)


def test_load_balance_term_gradient():
    from deeplearning4j_torch.gradientcheck import check_gradients

    layer = MixtureOfExpertsLayer(n_in=4, n_out=4, n_experts=2,
                                  expert_hidden=8, load_balance_coef=0.1)
    params = layer.init_params(torch.Generator().manual_seed(0))
    g = layer.regularization_grad(params)
    np.testing.assert_allclose(g["Wg"].numpy(),
                               2 * 0.1 * params["Wg"].numpy())
    b = importlib.import_module("deeplearning4j_torch.nn.conf.builders")
    layers = importlib.import_module("deeplearning4j_torch.nn.conf.layers")
    inputs = importlib.import_module("deeplearning4j_torch.nn.conf.inputs")
    conf = (b.NeuralNetConfiguration.builder().seed(42).weight_init("xavier")
            .dtype("float64")
            .list(layers.MixtureOfExpertsLayer(n_out=4, n_experts=2,
                                               expert_hidden=8,
                                               load_balance_coef=0.05),
                  layers.OutputLayer(n_out=3, loss="mcxent",
                                     activation="softmax"))
            .set_input_type(inputs.InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (6, 4))
    y = np.eye(3)[rng.integers(0, 3, 6)]
    assert check_gradients(net, x, y, train=False)


def test_learns_partitioned_function():
    rs = np.random.RandomState(4)
    n = 256
    regime = rs.randint(0, 2, n)
    x = rs.randn(n, 6).astype(np.float32)
    x[:, 0] = regime * 4 - 2
    labels = np.where(regime == 0, (x[:, 1] > 0).astype(int),
                      2 * (x[:, 2] > 0).astype(int))
    y = np.eye(3, dtype=np.float32)[labels]
    net = _net(top_k=1)
    ds = DataSet(x, y)
    for _ in range(150):
        net.fit(ds)
    pred = np.argmax(net.output(x).numpy(), 1)
    assert (pred == labels).mean() > 0.9


def test_serde_round_trip_and_validation(tmp_path):
    from deeplearning4j_torch.utils.model_serializer import (load_model,
                                                             save_model)

    net = _net()
    p = str(tmp_path / "moe.zip")
    save_model(net, p)
    back = load_model(p, device="cpu")
    x = np.random.RandomState(5).randn(3, 6).astype(np.float32)
    np.testing.assert_allclose(back.output(x).numpy(), net.output(x).numpy(),
                               atol=1e-6)
    assert back.layers[0].n_experts == 4
    assert back.layers[0].expert_hidden == 24
    with pytest.raises(ValueError):
        _net(top_k=9, n_experts=4)


def test_expert_hidden_defaults_to_four_n_out():
    conf = _conf("deeplearning4j_torch")
    layer = MixtureOfExpertsLayer(n_out=8)
    layer.finalize(None)
    assert layer.expert_hidden == 32
    assert conf.layers[0].param_order() == ("Wg", "W1", "b1", "W2", "b2")


# ------------------------------------------------------------ JAX parity
def test_forward_gates_and_selection_match_jax():
    jnet, net = _pair(top_k=2, n_experts=5)
    rs = np.random.RandomState(6)
    x = rs.randn(3, 7, 6).astype(np.float32)       # [B, T, F] tokens
    jl, tl = jnet.layers[0], net.layers[0]
    jgate = np.asarray(jl._gate(jnet.params["0"], jnp.asarray(x)))
    tgate = tl._gate(net.params["0"], torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(tgate > 0, jgate > 0)
    np.testing.assert_allclose(tgate, jgate, rtol=0, atol=1e-6)
    jout = np.asarray(jl.forward(jnet.params["0"], {}, jnp.asarray(x))[0])
    tout = tl.forward(net.params["0"], {}, torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(tout, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())


@pytest.mark.parametrize("row", [
    np.zeros(6),                                   # every expert tied
    np.array([1.0, -1.0, 0.0, 0.0, 0.0, 0.0]),
])
def test_tie_order_matches_lax_top_k(row):
    """All-equal logits and partly tied rows: the port keeps exactly the
    experts ``lax.top_k`` keeps (the lower index wins a tie)."""
    jnet, net = _pair(top_k=2, n_experts=5)
    # gate weights whose logits tie: experts 1..4 share a column
    wg = np.zeros((6, 5), np.float32)
    wg[0] = [2.0, 1.0, 1.0, 1.0, 1.0]
    jp = dict(jnet.params["0"], Wg=jnp.asarray(wg))
    tp = dict(net.params["0"], Wg=torch.from_numpy(wg))
    x = row[None].astype(np.float32)
    jgate = np.asarray(jnet.layers[0]._gate(jp, jnp.asarray(x)))
    tgate = net.layers[0]._gate(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(tgate > 0, jgate > 0)
    np.testing.assert_allclose(tgate, jgate, rtol=0, atol=1e-7)
    assert (tgate > 0).sum() == 2


def test_loss_gradients_and_steps_match_jax():
    """f64 loss and gradients with the load-balance term (its closed form
    added, as the step adds it), then two Adam steps in f32."""
    from deeplearning4j_torch.nn.regularization import (
        add_regularization_grads as treg)
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad
    from deeplearning4j_tpu.nn.regularization import (
        add_regularization_grads as jreg)

    jnet, net = _pair(top_k=2, n_experts=4, lb=0.05, dtype="float64")
    rs = np.random.RandomState(7)
    x = rs.randn(8, 6)
    y = np.eye(3)[rs.randint(0, 3, 8)]
    (jl, _), jg = jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                             None, None, train=True, rng=None),
        has_aux=True)(jnet.params)
    jg = _host(jreg(jnet, jnet.params, jg))
    tl, tg = value_and_grad(net, net.params, net.state, torch.from_numpy(x),
                            torch.from_numpy(y), train=True)
    with torch.no_grad():
        tg = treg(net, net.params, tg)
    assert abs(float(tl) - float(jl)) <= 1e-12 * abs(float(jl))
    for k, w in jg["0"].items():
        np.testing.assert_allclose(tg["0"][k].numpy(), w, rtol=0,
                                   atol=1e-10 * np.abs(w).max())
    jnet, net = _pair(top_k=2, n_experts=4)
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    for _ in range(2):
        jnet.do_step(x32, y32)
        net.do_step(x32, y32)
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=1e-5)


def test_zip_both_ways(tmp_path):
    from deeplearning4j_torch.utils import model_serializer as tms
    from deeplearning4j_tpu.utils import model_serializer as jms

    jnet, net = _pair()
    x = np.random.RandomState(8).randn(4, 6).astype(np.float32)
    p = str(tmp_path / "jax.zip")
    jms.save_model(jnet, p)
    loaded = tms.load_model(p, device="cpu")
    np.testing.assert_allclose(loaded.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    q = str(tmp_path / "port.zip")
    tms.save_model(net, q)
    back = jms.load_model(q)
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               net.output(x).numpy(), atol=1e-6)
    params_from_jax(_host(back.params), loaded)
    np.testing.assert_array_equal(loaded.params_flat(), net.params_flat())


# --------------------------------------------------------------- simple.py
def test_classification_results_match_jax():
    from deeplearning4j_torch.nn import simple as ts
    from deeplearning4j_tpu.nn import simple as js

    rs = np.random.RandomState(9)
    p = rs.dirichlet(np.ones(4), size=6).astype(np.float32)
    p[2] = [0.25, 0.25, 0.25, 0.25]               # a full tie
    labels = ["a", "b", "c", "d"]
    for probs in (p, torch.from_numpy(p)):
        t = ts.RankClassificationResult(probs, labels)
        j = js.RankClassificationResult(p, labels)
        assert t.max_output() == j.max_output()
        for i in range(6):
            assert t.ranked_classes(i) == j.ranked_classes(i)
            assert t.probability(i, "c") == j.probability(i, "c")
    assert ts.RankClassificationResult(p).labels == ["0", "1", "2", "3"]
    b = p[:, :2] / p[:, :2].sum(1, keepdims=True)
    for probs, thr in ((b, 0.5), (b[:, 1:], 0.3), (b[:, 1], 0.7)):
        t = ts.BinaryClassificationResult(torch.from_numpy(
            np.ascontiguousarray(probs)), thr)
        j = js.BinaryClassificationResult(probs, thr)
        np.testing.assert_array_equal(t.decisions(), j.decisions())
        assert t.positive_count() == j.positive_count()
    for bad in (p, np.zeros((2, 2, 2))):
        with pytest.raises(ValueError):
            ts.BinaryClassificationResult(bad)
    with pytest.raises(ValueError):
        ts.RankClassificationResult(p, ["x"])
