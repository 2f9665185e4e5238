"""The port's graph zoo (``models/zoo.py``: ResNet50, GoogLeNet,
FaceNetNN4Small2, InceptionResNetV1) against the JAX package's on the CPU.

Tier-1 (no whole-model compile):
- structure: each model's configuration JSON equals JAX's at the zoo
  shape (vertex names, order, every layer field), ResNet50 has 16
  ``ElementWiseVertex(add)`` joins, and the parameter counts equal JAX's
  (JAX's from the shapes its ``init_params`` would draw, abstractly);
- the registry equals JAX's ``zoo_models``;
- one block per model, built by both packages' helper methods
  (``_conv_block``, ``_identity_block``, ``_inception``, ``_block35``,
  ``_block17``, ``_block8``) at narrow widths behind a pooled head, on
  one set of weights: the training forward (batch statistics) within 1e-10 of
  max|y| and the f64 loss gradients within 1e-10 of each leaf's max|g|;
- ``init_pretrained`` raises.

Slow (each whole model's JAX compile takes 15–24 s): each model at
``tests/test_zoo.py``'s reduced shape (InceptionResNetV1 at 160), on
JAX's weights: f64 ``output(train=True)`` within 1e-6, the f64 gradients
within 1e-6 of each leaf's max|g|, and the f32 zip both ways bit for bit
(JAX cannot load a ResNet50 zip: ROADMAP C12).
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.models import zoo as tzoo
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.optimize.fused_fit import value_and_grad
from deeplearning4j_torch.utils.convert import (params_from_jax,
                                                state_from_jax)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.utils import serde as jserde

pytestmark = pytest.mark.torch_port

GRAPH_MODELS = ["ResNet50", "GoogLeNet", "FaceNetNN4Small2",
                "InceptionResNetV1"]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_net(jconf, net):
    """The JAX graph of ``jconf`` on the port net's weights (no JAX draw:
    JAX's ``init(params)`` takes them as they are)."""
    params = jax.tree_util.tree_map(
        jnp.asarray, {v: {k: t.numpy() for k, t in p.items()}
                      for v, p in net.params.items()})
    return JComputationGraph(jconf).init(params)


def _jax_param_count(conf):
    """JAX's parameter count of ``conf`` from ``jax.eval_shape`` of its
    vertices' ``init_params`` (no weights drawn)."""
    shapes = jax.eval_shape(
        lambda k: {n: conf.vertices[n].init_params(k, jnp.float32)
                   for n in conf.topo_order}, jax.random.PRNGKey(0))
    return int(sum(np.prod(s.shape) for s in
                   jax.tree_util.tree_leaves(shapes)))


@pytest.mark.parametrize("name", GRAPH_MODELS)
def test_graph_model_structure_matches_jax(name):
    jconf = getattr(jzoo, name)(num_labels=10).conf()
    tconf = getattr(tzoo, name)(num_labels=10).conf()
    assert json.loads(tconf.to_json()) == json.loads(jserde.to_json(jconf))
    assert tconf.topo_order == jconf.topo_order
    assert len(tconf.vertices) == len(jconf.vertices)
    net = ComputationGraph(tconf).init(device="cpu")
    assert net.num_params() == _jax_param_count(jconf)
    assert getattr(tzoo, name)().model_type() == "ComputationGraph"


def test_resnet50_residual_structure_and_registry():
    from deeplearning4j_torch.nn.conf.graph_conf import ElementWiseVertex

    conf = tzoo.ResNet50(num_labels=10, input_shape=(64, 64, 3)).conf()
    adds = [v for v in conf.vertices.values()
            if isinstance(v, ElementWiseVertex)]
    assert len(adds) == 16
    assert {k: v.__name__ for k, v in tzoo.zoo_models().items()} == \
        {k: v.__name__ for k, v in jzoo.zoo_models().items()}
    with pytest.raises(NotImplementedError):
        tzoo.ResNet50().init_pretrained()


# --------------------------------------------------------------- blocks
def _block_conf(pkg, model, block, hw, ch):
    """A graph of one block of ``model`` built by its helper method, at
    ``hw × hw × ch``, behind a global average pool and a 3-way softmax
    head, f64."""
    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
    core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
    pool = importlib.import_module(f"{pkg}.nn.conf.layers.pooling")
    upd = importlib.import_module(f"{pkg}.nn.updater")
    zoo = importlib.import_module(f"{pkg}.models.zoo")
    m = getattr(zoo, model)(num_labels=3)
    g = (b.NeuralNetConfiguration.builder().seed(11).activation("relu")
         .weight_init("relu").updater(upd.Sgd(learning_rate=0.1))
         .l2(1e-4).dtype("float64").graph_builder().add_inputs("input"))
    out = block(m, g)
    g.add_layer("avgpool", pool.GlobalPoolingLayer(pooling_type="avg"), out)
    g.add_layer("output", core.OutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"), "avgpool")
    g.set_outputs("output")
    g.set_input_types(inputs.InputType.convolutional(hw, hw, ch))
    return g.build()


BLOCKS = [
    ("ResNet50", "conv_block", lambda m, g: m._conv_block(
        g, (3, 3), (4, 4, 8), 2, "a", (2, 2), "input"), 8, 3),
    ("ResNet50", "identity_block", lambda m, g: m._identity_block(
        g, (3, 3), (3, 3, 5), 3, "b", "input"), 6, 5),
    ("GoogLeNet", "inception", lambda m, g: m._inception(
        g, "3a", ((4,), (3, 5), (2, 3), (2,)), "input"), 6, 3),
    ("FaceNetNN4Small2", "inception", lambda m, g: m._inception(
        g, "3a", (3, 2, 2, 4), (5, 3), "input"), 6, 3),
    ("FaceNetNN4Small2", "inception_5a", lambda m, g: m._inception(
        g, "5a", (3, 0, 2, 4), (5, 0), "input"), 5, 3),
    ("InceptionResNetV1", "block35", lambda m, g: m._block35(
        g, "block35-0", "input", ch=6), 5, 6),
    ("InceptionResNetV1", "block17", lambda m, g: m._block17(
        g, "block17-0", "input", ch=4), 4, 4),
    ("InceptionResNetV1", "block8", lambda m, g: m._block8(
        g, "block8-0", "input", ch=4), 3, 4),
]


@pytest.mark.parametrize("case", BLOCKS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_block_matches_jax(case):
    """The block's training forward and f64 loss gradients on the same
    weights (batch 2; L2 on, so the closed-form penalty gradient is held
    too). The weights are the port's draw, handed to JAX's ``init``."""
    from deeplearning4j_tpu.nn.regularization import (
        add_regularization_grads as jreg)
    from deeplearning4j_torch.nn.regularization import (
        add_regularization_grads as treg)

    model, _, block, hw, ch = case
    jconf = _block_conf("deeplearning4j_tpu", model, block, hw, ch)
    tconf = _block_conf("deeplearning4j_torch", model, block, hw, ch)
    assert json.loads(tconf.to_json()) == json.loads(jserde.to_json(jconf))
    net = ComputationGraph(tconf).init(device="cpu")
    jnet = _jax_net(jconf, net)
    rs = np.random.RandomState(3)
    x = rs.randn(2, hw, hw, ch)
    y = np.eye(3)[rs.randint(0, 3, 2)]
    jout = np.asarray(jnet.output(x, train=True))
    tout = net.output(x, train=True)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0,
                               atol=1e-10 * np.abs(jout).max())
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, [jnp.asarray(x)],
                             [jnp.asarray(y)], None, None, train=True,
                             rng=None), has_aux=True))(jnet.params)
    jg = _host(jreg(jnet, jnet.params, jg))
    tl, tg = value_and_grad(net, net.params, net.state,
                            [torch.from_numpy(x)], [torch.from_numpy(y)],
                            train=True)
    with torch.no_grad():
        tg = treg(net, net.params, tg)
    assert abs(float(tl) - float(jl)) <= 1e-12 * abs(float(jl))
    for v, leaves in jg.items():
        for k, w in leaves.items():
            np.testing.assert_allclose(
                tg[v][k].numpy(), w, rtol=0,
                atol=1e-10 * max(np.abs(w).max(), 1e-30),
                err_msg=f"{v}.{k}")


# ------------------------------------------------------- whole models (slow)
#: ``tests/test_zoo.py``'s reduced shapes, but InceptionResNetV1 at its zoo
#: shape: at 96 its block8 sees 1×1 activations, and batch norm over two
#: values amplifies f64 rounding to 3e-6 of the output (1e-9 at 160)
REDUCED = {"ResNet50": (64, 64, 3), "GoogLeNet": (64, 64, 3),
           "FaceNetNN4Small2": (64, 64, 3),
           "InceptionResNetV1": (160, 160, 3)}


def _model_pair(name, dtype):
    kw = dict(num_labels=10, input_shape=REDUCED[name], dtype=dtype)
    jnet = getattr(jzoo, name)(**kw).init()
    net = getattr(tzoo, name)(**kw).init(device="cpu")
    params_from_jax(_host(jnet.params), net)
    state_from_jax(_host(jnet.state), net)
    return jnet, net


@pytest.mark.slow
@pytest.mark.parametrize("name", GRAPH_MODELS)
def test_whole_model_output_and_zip_match_jax(name, tmp_path):
    """f64 ``output(train=True)`` within 1e-6 of JAX's (the untrained
    inference forward of ResNet50 overflows by design, and in f32 the
    rounding of two libraries moves the saturated softmax of these
    untrained deep nets by up to 0.1); then the f32 zip both ways: JAX's
    zip loads in the port with the parameters bit for bit and the output
    of the port net on those weights, and the port's zip loads in JAX bit
    for bit."""
    from deeplearning4j_torch.utils import model_serializer as tms
    from deeplearning4j_tpu.utils import model_serializer as jms

    jnet, net = _model_pair(name, "float64")
    x = np.random.RandomState(1).randn(2, *REDUCED[name])
    want = np.asarray(jnet.output(x, train=True))
    got = net.output(x, train=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.allclose(got.sum(axis=1), 1.0, atol=1e-9)
    jnet, net = _model_pair(name, "float32")
    x = x.astype(np.float32)
    p = str(tmp_path / "jax.zip")
    jms.save_model(jnet, p)
    loaded = tms.load_model(p, device="cpu")
    np.testing.assert_array_equal(loaded.params_flat(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(loaded.output(x, train=True).numpy(),
                                  net.output(x, train=True).numpy())
    q = str(tmp_path / "port.zip")
    tms.save_model(loaded, q)
    if name == "ResNet50":
        # the JAX package cannot load its own ResNet50 zip: its serde has
        # no registered Distribution (ROADMAP C12); the port's zip fails
        # there the same way
        for path in (p, q):
            with pytest.raises(ValueError, match="'Distribution'"):
                jms.load_model(path)
        return
    back = jms.load_model(q)
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  loaded.params_flat())


@pytest.mark.slow
@pytest.mark.parametrize("name", GRAPH_MODELS)
def test_whole_model_f64_gradients_match_jax(name):
    """The f64 first-step loss (rtol 1e-6) and gradients (training
    forward, the L1/L2 closed form added) within 1e-6 of each leaf's
    max|g| (of 1e-6 of the largest leaf's for a leaf that is zero in exact
    arithmetic): f64 rounding, amplified through 50-odd layers of
    untrained weights and batch statistics, parts the two libraries by up
    to 2e-8 of a leaf."""
    from deeplearning4j_tpu.nn.regularization import (
        add_regularization_grads as jreg)
    from deeplearning4j_torch.nn.regularization import (
        add_regularization_grads as treg)

    jnet, net = _model_pair(name, "float64")
    rs = np.random.RandomState(2)
    x = rs.randn(2, *REDUCED[name])
    y = np.eye(10)[rs.randint(0, 10, 2)]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, [jnp.asarray(x)],
                             [jnp.asarray(y)], None, None, train=True,
                             rng=None), has_aux=True))(jnet.params)
    jg = _host(jreg(jnet, jnet.params, jg))
    tl, tg = value_and_grad(net, net.params, net.state,
                            [torch.from_numpy(x)], [torch.from_numpy(y)],
                            train=True)
    with torch.no_grad():
        tg = treg(net, net.params, tg)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    # a leaf that is zero in exact arithmetic (a bias ahead of batch norm)
    # holds rounding only: its scale floors at 1e-6 of the largest leaf's
    floor = 1e-6 * max(np.abs(w).max() for leaves in jg.values()
                       for w in leaves.values())
    for v, leaves in jg.items():
        for k, w in leaves.items():
            np.testing.assert_allclose(
                tg[v][k].numpy(), w, rtol=0,
                atol=1e-6 * max(np.abs(w).max(), floor), err_msg=f"{v}.{k}")
