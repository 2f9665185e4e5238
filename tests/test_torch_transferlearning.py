"""The port's transfer learning (``nn/transferlearning.py``) against the
JAX package's on the CPU. Every case of ``tests/test_transferlearning.py``
runs on both packages from the same weights (the port's draw, handed to
JAX's ``init``); where a builder draws new weights (``nout_replace``, an
added layer), the port's rebuilt net's parameters are carried into JAX's
rebuilt net before any numbers are compared, and structure (frozen
layers, shapes, ``param_order``, the JSON) is compared as built. Numbers:
outputs within 1e-5, Adam steps to parameters within 1e-5 (f32); frozen
leaves and their batch-norm statistics bitwise unchanged by ``fit``, the
fused K-step driver included.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.nn.conf.layers.misc import FrozenLayer
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.nn import transferlearning as ttl
from deeplearning4j_torch.utils import serde as tserde
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork)
from deeplearning4j_tpu.utils import serde as jserde

pytestmark = pytest.mark.torch_port

ATOL = 1e-5


def _jtree(net):
    return jax.tree_util.tree_map(jnp.asarray, {
        v: {k: t.numpy() for k, t in p.items()}
        for v, p in net.params.items()})


def _carry(net, jnet):
    """Put the port net's parameters and state into the JAX net (the
    weights a builder drew on the port side)."""
    jnet.params = _jtree(net)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, {
        v: {k: t.numpy() for k, t in p.items()}
        for v, p in net.state.items()})
    jnet.updater_state = jnet.conf.updater.init(jnet.params)


def _mods(pkg):
    names = dict(b="nn.conf.builders", inputs="nn.conf.inputs",
                 core="nn.conf.layers.core", upd="nn.updater",
                 norm="nn.conf.layers.normalization",
                 gc="nn.conf.graph_conf")
    return {k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()}


def _mln_conf(pkg, n_in=4, n_out=3, seed=7, bn=False):
    m = _mods(pkg)
    D = m["core"].DenseLayer
    layers = [D(n_out=8, activation="tanh")]
    if bn:
        layers.append(m["norm"].BatchNormalization())
    layers += [D(n_out=6, activation="tanh"),
               m["core"].OutputLayer(n_out=n_out, activation="softmax",
                                     loss="mcxent")]
    return (m["b"].NeuralNetConfiguration.builder().seed(seed)
            .updater(m["upd"].Adam(learning_rate=0.01)).list(*layers)
            .set_input_type(m["inputs"].InputType.feed_forward(n_in))
            .build())


def _mln_pair(**kw):
    net = MultiLayerNetwork(_mln_conf("deeplearning4j_torch", **kw)).init(
        device="cpu")
    jnet = JMultiLayerNetwork(_mln_conf("deeplearning4j_tpu", **kw)).init(
        _jtree(net))
    return jnet, net


def _data(n=24, n_in=4, n_classes=3, seed=0):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, n_classes, n)
    x = (rs.randn(n, n_in) + labels[:, None]).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[labels]
    return DataSet(x, y), JDataSet(x, y)


def _same_json(conf, jconf):
    assert json.loads(conf.to_json()) == json.loads(jserde.to_json(jconf))


def _close(net, jnet, atol=ATOL):
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=atol)


def _both(builder_ops, jnet, net, graph=False):
    """Apply ``builder_ops(builder, pkg_mods)`` to each package's builder
    and build; the JSON of the two rebuilt nets is equal."""
    tb = (ttl.TransferLearning.GraphBuilder(net) if graph
          else ttl.TransferLearning.Builder(net))
    jb = (jtl.TransferLearning.GraphBuilder(jnet) if graph
          else jtl.TransferLearning.Builder(jnet))
    new = builder_ops(tb, _mods("deeplearning4j_torch")).build()
    jnew = builder_ops(jb, _mods("deeplearning4j_tpu")).build()
    _same_json(new.conf, jnew.conf)
    return jnew, new


def _fit_both(jnet, net, ds, jds, epochs):
    jnet.fit(jds, epochs=epochs)
    net.fit(ds, epochs=epochs)


# ------------------------------------------------------------------- MLN
def test_feature_extractor_freezes_layers():
    jnet, net = _mln_pair()
    ds, jds = _data()
    _fit_both(jnet, net, ds, jds, 3)
    _close(net, jnet)
    jnew, new = _both(lambda b, m: b.set_feature_extractor(1), jnet, net)
    assert [type(la).__name__ for la in new.conf.layers] == \
        [type(la).__name__ for la in jnew.conf.layers] == \
        ["FrozenLayer", "FrozenLayer", "OutputLayer"]
    _carry(new, jnew)
    frozen = {k: t.clone() for k, t in new.params["0"].items()}
    p2 = new.params["2"]["W"].clone()
    _fit_both(jnew, new, ds, jds, 5)
    for k, t in frozen.items():
        assert torch.equal(new.params["0"][k], t)
    assert not torch.equal(new.params["2"]["W"], p2)
    _close(new, jnew)


def test_frozen_params_copied_from_original():
    jnet, net = _mln_pair()
    ds, jds = _data()
    _fit_both(jnet, net, ds, jds, 2)
    jnew, new = _both(lambda b, m: b.set_feature_extractor(0), jnet, net)
    for i in ("0", "1", "2"):
        for k in net.params[i]:
            assert torch.equal(net.params[i][k], new.params[i][k])
            # a copy: training the new net leaves the original's alone
            assert net.params[i][k] is not new.params[i][k]
    _close(new, jnew)


def test_nout_replace_reinits_this_and_next():
    jnet, net = _mln_pair()
    jnew, new = _both(lambda b, m: b.nout_replace(1, 12,
                                                  weight_init="xavier"),
                      jnet, net)
    assert tuple(new.params["1"]["W"].shape) == (8, 12) == \
        tuple(jnew.params["1"]["W"].shape)
    assert tuple(new.params["2"]["W"].shape) == (12, 3)
    assert torch.equal(new.params["0"]["W"], net.params["0"]["W"])
    _carry(new, jnew)
    ds, jds = _data()
    _fit_both(jnew, new, ds, jds, 3)
    _close(new, jnew)


def test_remove_and_add_output_layer():
    jnet, net = _mln_pair()

    def ops(b, m):
        return (b.set_feature_extractor(1).remove_output_layer()
                .add_layer(m["core"].DenseLayer(n_out=5, activation="relu"))
                .add_layer(m["core"].OutputLayer(n_out=7,
                                                 activation="softmax",
                                                 loss="mcxent")))

    jnew, new = _both(ops, jnet, net)
    assert len(new.conf.layers) == 4
    _carry(new, jnew)
    ds, jds = _data(n_classes=7)
    out = new.output(ds.features)
    assert tuple(out.shape) == (24, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnew.output(
        jds.features)), rtol=0, atol=ATOL)
    _fit_both(jnew, new, ds, jds, 2)
    _close(new, jnew)
    with pytest.raises(ValueError, match="n >= 1"):
        ttl.TransferLearning.Builder(net).remove_layers_from_output(0)


def test_fine_tune_configuration_overrides():
    from deeplearning4j_torch.nn.updater import Sgd
    from deeplearning4j_tpu.nn.updater import Sgd as JSgd

    jnet, net = _mln_pair()
    new = (ttl.TransferLearning.Builder(net).fine_tune_configuration(
        ttl.FineTuneConfiguration(updater=Sgd(learning_rate=0.5), l2=0.01,
                                  seed=99)).build())
    jnew = (jtl.TransferLearning.Builder(jnet).fine_tune_configuration(
        jtl.FineTuneConfiguration(updater=JSgd(learning_rate=0.5), l2=0.01,
                                  seed=99)).build())
    _same_json(new.conf, jnew.conf)
    assert type(new.conf.updater).__name__ == "Sgd"
    assert new.conf.updater.learning_rate == 0.5
    assert new.conf.seed == 99 and new.conf.layers[1].l2 == 0.01
    ftc = ttl.FineTuneConfiguration(learning_rate=0.3, dropout=0.1)
    assert json.loads(tserde.to_json(ftc)) == json.loads(jserde.to_json(
        jtl.FineTuneConfiguration(learning_rate=0.3, dropout=0.1)))
    assert tserde.from_json(tserde.to_json(ftc)) == ftc


def test_transfer_net_trains():
    jnet, net = _mln_pair()
    ds, jds = _data()
    _fit_both(jnet, net, ds, jds, 3)
    jnew, new = _both(lambda b, m: b.set_feature_extractor(0).nout_replace(
        2, 3, weight_init="xavier"), jnet, net)
    _carry(new, jnew)
    s0 = new.score(ds)
    _fit_both(jnew, new, ds, jds, 10)
    assert new.score(ds) < s0
    _close(new, jnew)


def test_frozen_batch_norm_and_adam_state_unchanged_by_fused_fit():
    """A frozen batch norm keeps its running statistics, and every frozen
    leaf (with its Adam moments) stays bitwise as it was, through the fused
    K-step driver (K = 2) and ``fused_steps=1`` alike; JAX's net agrees."""
    jnet, net = _mln_pair(bn=True)
    ds, jds = _data()
    _fit_both(jnet, net, ds, jds, 2)
    jnew, new = _both(lambda b, m: b.set_feature_extractor(2), jnet, net)
    _carry(new, jnew)
    frozen = {i: {k: t.clone() for k, t in new.params[i].items()}
              for i in ("0", "1", "2")}
    bn_state = {k: t.clone() for k, t in new.state["1"].items()}
    stream = [_data(seed=s)[0] for s in range(4)]
    new.fit(stream)                               # K = 2 on the CPU
    new.fit(stream[0], fused_steps=1)
    jnew.fit([_data(seed=s)[1] for s in range(4)])
    jnew.fit(_data(seed=0)[1], fused_steps=1)
    for i, leaves in frozen.items():
        for k, t in leaves.items():
            assert torch.equal(new.params[i][k], t)
            for slot in new.updater_state.values():
                assert not slot[i][k].any()
    for k, t in bn_state.items():
        assert torch.equal(new.state["1"][k], t)
    _close(new, jnew)


# ---------------------------------------------------------------- helper
def test_helper_featurize_and_fit():
    jnet, net = _mln_pair()
    ds, jds = _data()
    _fit_both(jnet, net, ds, jds, 2)
    jnew, new = _both(lambda b, m: b.set_feature_extractor(1), jnet, net)
    helper = ttl.TransferLearningHelper(new)
    jhelper = jtl.TransferLearningHelper(jnew)
    fds, jfds = helper.featurize(ds), jhelper.featurize(jds)
    assert fds.features.shape == (24, 6)
    np.testing.assert_allclose(fds.features, np.asarray(jfds.features),
                               rtol=0, atol=ATOL)
    s0 = helper.unfrozen_mln().score(fds)
    helper.fit_featurized(fds, epochs=10)
    jhelper.fit_featurized(jfds, epochs=10)
    assert helper.unfrozen_mln().score(fds) < s0
    out_full = new.output(ds.features).numpy()
    out_sub = helper.output_featurized(fds.features).numpy()
    np.testing.assert_allclose(out_full, out_sub, atol=1e-5)
    np.testing.assert_allclose(out_sub, np.asarray(
        jhelper.output_featurized(jfds.features)), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="no frozen"):
        ttl.TransferLearningHelper(net)


# ----------------------------------------------------------------- graphs
def _graph_conf(pkg, merge=False):
    m = _mods(pkg)
    D = m["core"].DenseLayer
    g = (m["b"].NeuralNetConfiguration.builder().seed(3)
         .updater(m["upd"].Adam(learning_rate=0.01)).graph_builder()
         .add_inputs("in")
         .add_layer("d1", D(n_out=8, activation="tanh"), "in"))
    if merge:
        g.add_layer("d1b", D(n_out=3, activation="relu"), "in")
        g.add_vertex("m", m["gc"].MergeVertex(), "d1", "d1b")
        g.add_layer("d2", D(n_out=6, activation="tanh"), "m")
    else:
        g.add_layer("d2", D(n_out=6, activation="tanh"), "d1")
    return (g.add_layer("out", m["core"].OutputLayer(
        n_out=3, activation="softmax", loss="mcxent"), "d2")
        .set_outputs("out")
        .set_input_types(m["inputs"].InputType.feed_forward(4)).build())


def _graph_pair(merge=False, conf=_graph_conf):
    net = ComputationGraph(conf("deeplearning4j_torch", merge)).init(
        device="cpu")
    jnet = JComputationGraph(conf("deeplearning4j_tpu", merge)).init(
        _jtree(net))
    return jnet, net


@pytest.mark.parametrize("merge", [False, True])
def test_graph_freeze_ancestors(merge):
    jnet, net = _graph_pair(merge)
    ds, jds = _data()
    _fit_both(jnet, net, ds, jds, 2)
    jnew, new = _both(lambda b, m: b.set_feature_extractor("d2"), jnet, net,
                      graph=True)
    frozen = ["d1", "d2"] + (["d1b"] if merge else [])
    for n in frozen:
        assert isinstance(new.conf.vertices[n].layer, FrozenLayer)
    assert not isinstance(new.conf.vertices["out"].layer, FrozenLayer)
    _carry(new, jnew)
    d1 = new.params["d1"]["W"].clone()
    _fit_both(jnew, new, ds, jds, 4)
    assert torch.equal(new.params["d1"]["W"], d1)
    _close(new, jnew)


def test_graph_replace_head():
    jnet, net = _graph_pair(True)

    def ops(b, m):
        return (b.set_feature_extractor("d2")
                .remove_vertex_and_connections("out")
                .add_layer("newout", m["core"].OutputLayer(
                    n_out=5, activation="softmax", loss="mcxent"), "d2")
                .set_outputs("newout"))

    jnew, new = _both(ops, jnet, net, graph=True)
    _carry(new, jnew)
    ds, jds = _data(n_classes=5)
    out = new.output(ds.features)
    assert tuple(out.shape) == (24, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnew.output(
        jds.features)), rtol=0, atol=ATOL)
    _fit_both(jnew, new, ds, jds, 2)
    _close(new, jnew)
    assert "newout" in new.conf.vertices


def test_graph_nout_replace():
    jnet, net = _graph_pair()
    jnew, new = _both(lambda b, m: b.nout_replace("d2", 10,
                                                  weight_init="xavier"),
                      jnet, net, graph=True)
    assert tuple(new.params["d2"]["W"].shape) == (8, 10)
    assert tuple(new.params["out"]["W"].shape) == (10, 3)
    assert torch.equal(new.params["d1"]["W"], net.params["d1"]["W"])
    with pytest.raises(ValueError, match="not a layer vertex"):
        (ttl.TransferLearning.GraphBuilder(_graph_pair(True)[1])
         .nout_replace("m", 3))


def _residual_conf(pkg, _merge=False):
    m = _mods(pkg)
    D = m["core"].DenseLayer
    return (m["b"].NeuralNetConfiguration.builder().seed(5)
            .updater(m["upd"].Adam(learning_rate=0.01)).graph_builder()
            .add_inputs("in")
            .add_layer("d1", D(n_out=6, activation="tanh"), "in")
            .add_layer("d2", D(n_out=6, activation="identity"), "d1")
            .add_vertex("res", m["gc"].ElementWiseVertex(op="add"), "d1",
                        "d2")
            .add_layer("act", m["core"].ActivationLayer(activation="relu"),
                       "res")
            .add_layer("out", m["core"].OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "act")
            .set_outputs("out")
            .set_input_types(m["inputs"].InputType.feed_forward(4)).build())


def test_graph_nout_replace_through_parameterless_vertices():
    jnet, net = _graph_pair(conf=_residual_conf)
    jnew, new = _both(lambda b, m: b.nout_replace(
        "d1", 9, weight_init="xavier").nout_replace("d2", 9,
                                                    weight_init="xavier"),
        jnet, net, graph=True)
    assert tuple(new.params["out"]["W"].shape) == (9, 3)
    _carry(new, jnew)
    ds, jds = _data()
    out = new.output(ds.features)
    assert tuple(out.shape) == (24, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnew.output(
        jds.features)), rtol=0, atol=ATOL)


def test_graph_remove_vertex_keep_connections_and_add_vertex():
    jnet, net = _graph_pair(conf=_residual_conf)

    def ops(b, m):
        return (b.remove_vertex_keep_connections("act")
                .add_vertex("scaled", m["gc"].ScaleVertex(scale=0.5), "res")
                .remove_vertex_and_connections("out")
                .add_layer("out2", m["core"].OutputLayer(
                    n_out=3, activation="softmax", loss="mcxent"), "scaled")
                .set_outputs("out2"))

    jnew, new = _both(ops, jnet, net, graph=True)
    assert "act" not in new.conf.vertices
    assert new.conf.vertex_inputs["scaled"] == ["res"]
    _carry(new, jnew)
    ds, jds = _data()
    np.testing.assert_allclose(new.output(ds.features).numpy(),
                               np.asarray(jnew.output(jds.features)),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="single-input"):
        (ttl.TransferLearning.GraphBuilder(net)
         .remove_vertex_keep_connections("res"))


def test_graph_helper_matches_the_frozen_graph_fit():
    """Beyond the JAX helper (MultiLayerNetwork only): on a graph frozen
    through ``d2`` behind a merge, ``featurize`` then ``fit_featurized``
    gives the frozen graph's own ``fit`` (fused_steps=1) head parameters
    within 1e-6, and the helper's output equals the graph's."""
    _, net = _graph_pair(True)
    new = ttl.TransferLearning.GraphBuilder(net).set_feature_extractor(
        "d2").build()
    twin = new.clone()
    ds, _ = _data()
    helper = ttl.TransferLearningHelper(new)
    assert helper._boundary == ["d2"]
    fds = helper.featurize(ds)
    assert fds.features.shape == (24, 6)
    helper.fit_featurized(fds, epochs=3)
    twin.fit(ds, epochs=3, fused_steps=1)
    np.testing.assert_allclose(new.params["out"]["W"].numpy(),
                               twin.params["out"]["W"].numpy(), rtol=0,
                               atol=1e-6)
    for n in ("d1", "d1b", "d2"):
        assert torch.equal(new.params[n]["W"], net.params[n]["W"])
    np.testing.assert_allclose(helper.output_featurized(fds.features)
                               .numpy(), new.output(ds.features).numpy(),
                               rtol=0, atol=1e-6)
