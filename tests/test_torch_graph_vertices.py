"""The port's graph vertices against the JAX package's
(``nn/conf/graph_conf.py``) on the CPU, and the call forms of ROADMAP C11:

- every vertex's forward and its input gradients (one seeded cotangent)
  against JAX's on the same numpy inputs, f32 within rtol 1e-5 (+1e-6
  absolute, for values near zero);
- ``gradientcheck.check_gradients`` passes on the counterparts of
  ``tests/test_graph.py::TestGraphGradients`` (merge, skip-add,
  multi-input/multi-output, LSTM to ``LastTimeStepVertex``), f64 nets on
  the JAX nets' weights;
- the counterparts of ``TestVertexOps`` and ``TestGraphStructure``;
- a graph holding every vertex: its JSON and its zip written by either
  package load in the other, outputs within 1e-5 of max|y|;
- C11: ``updater(name[, lr])`` resolves as JAX's ``get_updater`` does
  (same JSON) and trains; ``ComputationGraph.output(train=True)`` equals
  JAX's (batch statistics, the batch bucketed as JAX buckets it); and
  ``GraphBuilder.add_layer(preprocessor=)`` builds JAX's JSON.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.gradientcheck import check_gradients
from deeplearning4j_torch.nn.conf import graph_conf as tg
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.utils import serde as tserde
from deeplearning4j_torch.utils.convert import (params_from_jax,
                                                state_from_jax)
from deeplearning4j_tpu.nn.conf import graph_conf as jg
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.utils import serde as jserde

pytestmark = pytest.mark.torch_port

RTOL = 1e-5
ATOL = 1e-6


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _mods(pkg):
    names = dict(b="nn.conf.builders", gc="nn.conf.graph_conf",
                 inputs="nn.conf.inputs", core="nn.conf.layers.core",
                 conv="nn.conf.layers.convolution",
                 norm="nn.conf.layers.normalization",
                 rec="nn.conf.layers.recurrent", upd="nn.updater",
                 pp="nn.conf.preprocessors")
    return {k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()}


def _pair(build, dtype="float64"):
    """``build(mods, dtype)`` -> conf in each package (the same JSON); the
    JAX graph on the port's drawn weights, and the port's on the JAX
    graph's weights and state."""
    jconf = build(_mods("deeplearning4j_tpu"), dtype)
    tconf = build(_mods("deeplearning4j_torch"), dtype)
    assert json.loads(tconf.to_json()) == json.loads(jserde.to_json(jconf))
    net = ComputationGraph(tconf).init(device="cpu")
    jnet = JComputationGraph(jconf).init(jax.tree_util.tree_map(
        jnp.asarray, {v: {k: t.numpy() for k, t in p.items()}
                      for v, p in net.params.items()}))
    # and back through the converter, as a JAX-trained tree would come
    params_from_jax(_host(jnet.params), net)
    state_from_jax(_host(jnet.state), net)
    return jnet, net


# ----------------------------------------------------------- vertex parity
def _vertex_cases():
    rs = np.random.RandomState(0)
    a, b = rs.randn(3, 5), rs.randn(3, 5)
    img = rs.randn(2, 4, 5, 3)
    seq = rs.randn(2, 6, 4)
    mask = np.array([[1, 1, 0, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.float64)
    return [
        ("merge", lambda m: m.MergeVertex(), [a, b, rs.randn(3, 2)], {}),
        ("merge_nhwc", lambda m: m.MergeVertex(), [img, img[..., :2]], {}),
        ("add", lambda m: m.ElementWiseVertex(op="add"), [a, b, a], {}),
        ("subtract", lambda m: m.ElementWiseVertex(op="subtract"), [a, b],
         {}),
        ("product", lambda m: m.ElementWiseVertex(op="product"), [a, b], {}),
        ("average", lambda m: m.ElementWiseVertex(op="average"), [a, b, b],
         {}),
        ("max", lambda m: m.ElementWiseVertex(op="max"), [a, b], {}),
        ("subset", lambda m: m.SubsetVertex(from_index=1, to_index=3), [a],
         {}),
        ("subset_seq", lambda m: m.SubsetVertex(from_index=0, to_index=1),
         [seq], {}),
        ("stack", lambda m: m.StackVertex(), [a, b], {}),
        ("unstack", lambda m: m.UnstackVertex(from_index=2, stack_size=3),
         [rs.randn(9, 4)], {}),
        ("scale", lambda m: m.ScaleVertex(scale=-2.5), [a], {}),
        ("shift", lambda m: m.ShiftVertex(shift=0.75), [a], {}),
        ("l2", lambda m: m.L2Vertex(), [img, img[::-1].copy()], {}),
        ("l2_zero", lambda m: m.L2Vertex(), [a, a], {}),
        ("l2_normalize", lambda m: m.L2NormalizeVertex(), [img], {}),
        ("reshape", lambda m: m.ReshapeVertex(shape=(3, 5, 4)), [img], {}),
        ("pool_helper", lambda m: m.PoolHelperVertex(), [img], {}),
        ("preprocessor", lambda m: m.PreprocessorVertex(
            preprocessor=m.pp.CnnToFeedForwardPreProcessor(4, 5, 3)), [img],
         {}),
        ("last_step", lambda m: m.LastTimeStepVertex(mask_input="in"), [seq],
         dict(ctx=lambda t: {"input_masks": {"in": t(mask)},
                             "input_arrays": {}})),
        ("last_step_nomask", lambda m: m.LastTimeStepVertex(), [seq], {}),
        ("duplicate", lambda m: m.DuplicateToTimeSeriesVertex(
            input_name="seq"), [a], dict(ctx=lambda t: {
                "input_arrays": {"seq": t(seq)}, "input_masks": {}})),
    ]


def _vertex_of(make, pkg):
    gc = importlib.import_module(f"{pkg}.nn.conf.graph_conf")
    pp = importlib.import_module(f"{pkg}.nn.conf.preprocessors")

    class M:
        def __getattr__(self, k):
            return getattr(gc, k)

    m = M()
    m.pp = pp
    return make(m)


@pytest.mark.parametrize("case", _vertex_cases(), ids=lambda c: c[0])
def test_vertex_forward_and_input_gradients_match_jax(case):
    """f32 forward and the vector-Jacobian product of one seeded
    cotangent, per input, within rtol 1e-5 of JAX's."""
    name, make, arrays, kw = case
    arrays = [a.astype(np.float32) for a in arrays]
    jv = _vertex_of(make, "deeplearning4j_tpu")
    tv = _vertex_of(make, "deeplearning4j_torch")
    jctx = kw["ctx"](jnp.asarray) if "ctx" in kw else None
    tctx = kw["ctx"](torch.from_numpy) if "ctx" in kw else None

    def jf(*xs):
        return jv.forward({}, {}, list(xs), ctx=jctx)[0]

    jout, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in arrays])
    cot = np.random.RandomState(1).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout, _ = tv.forward({}, {}, xs, ctx=tctx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL, err_msg=name)
    tgrads = torch.autograd.grad(tout, xs, torch.from_numpy(cot),
                                 allow_unused=True)
    for i, (tgr, jgr) in enumerate(zip(tgrads, jgrads)):
        tgr = np.zeros_like(arrays[i]) if tgr is None else tgr.numpy()
        np.testing.assert_allclose(tgr, np.asarray(jgr), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} input {i}")
    # the mask a vertex hands on
    masks = [np.ones(arrays[0].shape[:2], np.float32)]
    jm = jv.feed_forward_mask([jnp.asarray(masks[0])])
    tm = tv.feed_forward_mask([torch.from_numpy(masks[0])])
    assert (jm is None) == (tm is None)
    if jm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("types", [
    ("merge", lambda I: [I.convolutional(4, 5, 3), I.convolutional(4, 5, 2)]),
    ("merge", lambda I: [I.recurrent(3, 7), I.recurrent(4, 7)]),
    ("merge", lambda I: [I.feed_forward(3), I.convolutional_flat(2, 2, 1)]),
    ("subset", lambda I: [I.recurrent(6, 5)]),
    ("subset", lambda I: [I.convolutional(4, 4, 6)]),
    ("subset", lambda I: [I.feed_forward(6)]),
    ("l2", lambda I: [I.feed_forward(6), I.feed_forward(6)]),
    ("pool_helper", lambda I: [I.convolutional(5, 6, 2)]),
    ("reshape", lambda I: [I.feed_forward(6)]),
    ("preprocessor", lambda I: [I.convolutional(4, 5, 3)]),
], ids=lambda t: t[0])
def test_vertex_output_types_match_jax(types):
    name, make_types = types
    case = {c[0]: c[1] for c in _vertex_cases()}[name]
    got = []
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_torch"):
        I = importlib.import_module(f"{pkg}.nn.conf.inputs").InputType
        v = _vertex_of(case, pkg)
        got.append(v.output_type(make_types(I)))
    assert json.loads(jserde.to_json(got[0])) == json.loads(
        tserde.to_json(got[1]))


# ------------------------------------------------ TestVertexOps counterparts
def _run(vertex, inputs, **kw):
    out, _ = vertex.forward({}, {}, [torch.as_tensor(np.asarray(a))
                                     for a in inputs], **kw)
    return out.numpy()


def test_elementwise_ops():
    a = np.array([[1.0, 2.0]])
    b = np.array([[3.0, -1.0]])
    assert np.allclose(_run(tg.ElementWiseVertex(op="add"), [a, b]),
                       [[4, 1]])
    assert np.allclose(_run(tg.ElementWiseVertex(op="subtract"), [a, b]),
                       [[-2, 3]])
    assert np.allclose(_run(tg.ElementWiseVertex(op="product"), [a, b]),
                       [[3, -2]])
    assert np.allclose(_run(tg.ElementWiseVertex(op="average"), [a, b]),
                       [[2, 0.5]])
    assert np.allclose(_run(tg.ElementWiseVertex(op="max"), [a, b]), [[3, 2]])
    with pytest.raises(ValueError, match="exactly 2"):
        _run(tg.ElementWiseVertex(op="subtract"), [a, b, a])
    with pytest.raises(ValueError, match="Unknown ElementWiseVertex"):
        _run(tg.ElementWiseVertex(op="min"), [a, b])


def test_subset_stack_unstack_scale_shift():
    x = np.arange(12.0).reshape(2, 6)
    out = _run(tg.SubsetVertex(from_index=1, to_index=3), [x])
    assert out.shape == (2, 3) and np.allclose(out, x[:, 1:4])
    a = np.random.RandomState(0).randn(2, 3)
    b = np.random.RandomState(1).randn(2, 3)
    stacked = _run(tg.StackVertex(), [a, b])
    assert stacked.shape == (4, 3)
    assert np.allclose(_run(tg.UnstackVertex(from_index=1, stack_size=2),
                            [stacked]), b)
    ones = np.ones((2, 2))
    assert np.allclose(_run(tg.ScaleVertex(scale=3.0), [ones]), 3.0)
    assert np.allclose(_run(tg.ShiftVertex(shift=-1.5), [ones]), -0.5)


def test_l2_l2normalize_reshape_pool_helper():
    a = np.array([[3.0, 0.0], [0.0, 0.0]])
    b = np.array([[0.0, 4.0], [0.0, 0.0]])
    out = _run(tg.L2Vertex(), [a, b])
    assert out.shape == (2, 1) and np.allclose(out[0, 0], 5.0, atol=1e-3)
    assert np.allclose(_run(tg.L2NormalizeVertex(), [np.array([[3.0, 4.0]])]),
                       [[0.6, 0.8]], atol=1e-4)
    x = np.arange(24.0).reshape(2, 12)
    assert _run(tg.ReshapeVertex(shape=(3, 4)), [x]).shape == (2, 3, 4)
    img = np.arange(2 * 3 * 4 * 2, dtype=np.float64).reshape(2, 3, 4, 2)
    assert np.array_equal(_run(tg.PoolHelperVertex(), [img]),
                          img[:, 1:, 1:, :])


def test_last_time_step_noncontiguous_mask_and_duplicate():
    x = np.arange(2 * 4 * 3, dtype=np.float64).reshape(2, 4, 3)
    mask = torch.tensor([[1, 0, 1, 0], [1, 1, 0, 0]], dtype=torch.float64)
    out = _run(tg.LastTimeStepVertex(mask_input="in"), [x],
               ctx={"input_masks": {"in": mask}})
    assert np.allclose(out[0], x[0, 2]) and np.allclose(out[1], x[1, 1])
    ref = torch.zeros((1, 5, 7))
    out = _run(tg.DuplicateToTimeSeriesVertex(input_name="seq"),
               [np.array([[1.0, 2.0]])],
               ctx={"input_arrays": {"seq": ref}, "input_masks": {}})
    assert out.shape == (1, 5, 2) and np.allclose(out[0, 3], [1.0, 2.0])


# ------------------------------------------- TestGraphStructure counterparts
def _simple(m, dtype="float64"):
    return (m["b"].NeuralNetConfiguration.builder().seed(12345)
            .updater(m["upd"].Sgd(learning_rate=0.1)).dtype(dtype)
            .graph_builder().add_inputs("in")
            .add_layer("a", m["core"].DenseLayer(n_out=5, activation="tanh"),
                       "in")
            .add_layer("b", m["core"].DenseLayer(n_out=4, activation="relu"),
                       "in")
            .add_vertex("merge", m["gc"].MergeVertex(), "a", "b")
            .add_layer("out", m["core"].OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "merge")
            .set_outputs("out")
            .set_input_types(m["inputs"].InputType.feed_forward(6))
            .build())


def test_topo_sort_nin_inference_and_validation():
    conf = _simple(_mods("deeplearning4j_torch"))
    order = conf.topo_order
    assert order.index("a") < order.index("merge") < order.index("out")
    assert order.index("b") < order.index("merge")
    assert conf.vertices["out"].layer.n_in == 9
    assert conf.vertices["a"].layer.n_in == 6
    m = _mods("deeplearning4j_torch")
    D = m["core"].DenseLayer
    b = (m["b"].NeuralNetConfiguration.builder().graph_builder()
         .add_inputs("in").add_layer("a", D(n_in=3, n_out=3), "b")
         .add_layer("b", D(n_in=3, n_out=3), "a").set_outputs("b"))
    with pytest.raises(ValueError, match="cycle"):
        b.build()
    b = (m["b"].NeuralNetConfiguration.builder().graph_builder()
         .add_inputs("in").add_layer("a", D(n_in=3, n_out=3), "nope")
         .set_outputs("a"))
    with pytest.raises(ValueError, match="unknown input"):
        b.build()
    b = (m["b"].NeuralNetConfiguration.builder().graph_builder()
         .add_inputs("in").add_layer("a", D(n_in=3, n_out=3), "in"))
    with pytest.raises(ValueError, match="duplicate"):
        b.add_layer("a", D(n_in=3, n_out=3), "in")


# ------------------------------------------ TestGraphGradients counterparts
def _skip_add(m, dtype):
    D = m["core"].DenseLayer
    return (m["b"].NeuralNetConfiguration.builder().seed(7)
            .updater(m["upd"].Sgd(learning_rate=0.1)).dtype(dtype)
            .graph_builder().add_inputs("in")
            .add_layer("d1", D(n_out=5, activation="tanh"), "in")
            .add_layer("d2", D(n_out=5, activation="tanh"), "d1")
            .add_vertex("add", m["gc"].ElementWiseVertex(op="add"), "d1",
                        "d2")
            .add_layer("out", m["core"].OutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), "add")
            .set_outputs("out")
            .set_input_types(m["inputs"].InputType.feed_forward(4)).build())


def _multi_io(m, dtype):
    D, O = m["core"].DenseLayer, m["core"].OutputLayer
    I = m["inputs"].InputType
    return (m["b"].NeuralNetConfiguration.builder().seed(3)
            .updater(m["upd"].Sgd(learning_rate=0.1)).dtype(dtype)
            .graph_builder().add_inputs("in1", "in2")
            .add_layer("d1", D(n_out=4, activation="tanh"), "in1")
            .add_layer("d2", D(n_out=4, activation="tanh"), "in2")
            .add_vertex("merge", m["gc"].MergeVertex(), "d1", "d2")
            .add_layer("shared", D(n_out=6, activation="tanh"), "merge")
            .add_layer("out1", O(n_out=2, activation="softmax",
                                 loss="mcxent"), "shared")
            .add_layer("out2", O(n_out=3, activation="identity", loss="mse"),
                       "shared")
            .set_outputs("out1", "out2")
            .set_input_types(I.feed_forward(3), I.feed_forward(5)).build())


def _lstm_last(m, dtype):
    return (m["b"].NeuralNetConfiguration.builder().seed(5)
            .updater(m["upd"].Sgd(learning_rate=0.1)).dtype(dtype)
            .graph_builder().add_inputs("in")
            .add_layer("lstm", m["rec"].LSTM(n_out=4, activation="tanh"),
                       "in")
            .add_vertex("last", m["gc"].LastTimeStepVertex(mask_input="in"),
                        "lstm")
            .add_layer("out", m["core"].OutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), "last")
            .set_outputs("out")
            .set_input_types(m["inputs"].InputType.recurrent(3)).build())


def _onehot(rs, n, c):
    return np.eye(c)[rs.randint(0, c, n)]


@pytest.mark.parametrize("which", ["merge", "skip_add", "multi_io",
                                   "lstm_last"])
def test_graph_gradient_checks(which):
    """``check_gradients`` (eps 1e-6, max_rel_error 1e-5, as JAX's tests
    run it) on f64 graphs carrying the JAX graphs' weights; the analytic
    loss and gradients also equal JAX's within 1e-10 of max|g|."""
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    im = None
    if which == "merge":
        build, rs = _simple, np.random.RandomState(1)
        x, y = rs.randn(4, 6), _onehot(rs, 4, 3)
    elif which == "skip_add":
        build, rs = _skip_add, np.random.RandomState(2)
        x, y = rs.randn(3, 4), _onehot(rs, 3, 2)
    elif which == "multi_io":
        build, rs = _multi_io, np.random.RandomState(4)
        x = [rs.randn(3, 3), rs.randn(3, 5)]
        y = [_onehot(rs, 3, 2), rs.randn(3, 3)]
    else:
        build, rs = _lstm_last, np.random.RandomState(6)
        x, y = rs.randn(2, 5, 3), _onehot(rs, 2, 2)
        im = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float64)
    jnet, net = _pair(lambda m, dt: build(m, dt))
    assert check_gradients(net, x, y, input_mask=im, eps=1e-6,
                           max_rel_error=1e-5)
    xs = [jnp.asarray(a) for a in (x if isinstance(x, list) else [x])]
    ys = [jnp.asarray(a) for a in (y if isinstance(y, list) else [y])]
    jim = None if im is None else [jnp.asarray(im)]
    (jl, _), jgr = jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, xs, ys, jim, None, train=True,
                             rng=None), has_aux=True)(jnet.params)
    bx, by, bim, blm = net._batch(x, y, im, None)
    tl, tgr = value_and_grad(net, net.params, net.state, bx, by, bim, blm,
                             train=True)
    assert abs(float(tl) - float(jl)) <= 1e-12 * max(1.0, abs(float(jl)))
    for v, leaves in _host(jgr).items():
        for k, w in leaves.items():
            np.testing.assert_allclose(tgr[v][k].numpy(), w, rtol=0,
                                       atol=1e-10 * max(1.0,
                                                        np.abs(w).max()))


# ------------------------------------------------- a graph of every vertex
def _every_vertex(m, dtype="float32"):
    gc, core, I = m["gc"], m["core"], m["inputs"].InputType
    g = (m["b"].NeuralNetConfiguration.builder().seed(21)
         .updater(m["upd"].Adam(learning_rate=1e-2)).dtype(dtype)
         .graph_builder().add_inputs("a", "b", "img", "seq")
         .set_input_types(I.feed_forward(6), I.feed_forward(6),
                          I.convolutional(5, 5, 2), I.recurrent(3)))
    g.add_layer("da", core.DenseLayer(n_out=4, activation="tanh"), "a")
    g.add_layer("db", core.DenseLayer(n_out=4, activation="tanh"), "b")
    g.add_vertex("merge", gc.MergeVertex(), "da", "db")
    g.add_vertex("sub", gc.SubsetVertex(from_index=1, to_index=5), "merge")
    g.add_vertex("ew", gc.ElementWiseVertex(op="max"), "da", "db")
    g.add_vertex("stack", gc.StackVertex(), "da", "db")
    g.add_vertex("unstack", gc.UnstackVertex(from_index=1, stack_size=2),
                 "stack")
    g.add_vertex("scale", gc.ScaleVertex(scale=0.5), "unstack")
    g.add_vertex("shift", gc.ShiftVertex(shift=0.25), "scale")
    g.add_vertex("l2", gc.L2Vertex(), "da", "db")
    g.add_vertex("l2n", gc.L2NormalizeVertex(), "merge")
    g.add_vertex("rs1", gc.ReshapeVertex(shape=(2, 4)), "l2n")
    g.add_vertex("rs2", gc.ReshapeVertex(shape=(8,)), "rs1")
    g.add_layer("conv", m["conv"].ConvolutionLayer(
        n_out=3, kernel_size=(2, 2), activation="relu"), "img")
    g.add_vertex("crop", gc.PoolHelperVertex(), "conv")
    g.add_vertex("flat", gc.PreprocessorVertex(
        preprocessor=m["pp"].CnnToFeedForwardPreProcessor(3, 3, 3)), "crop")
    g.add_layer("lstm", m["rec"].LSTM(n_out=4, activation="tanh"), "seq")
    g.add_vertex("last", gc.LastTimeStepVertex(mask_input="seq"), "lstm")
    g.add_vertex("dup", gc.DuplicateToTimeSeriesVertex(input_name="seq"),
                 "last")
    g.add_vertex("all", gc.MergeVertex(), "sub", "ew", "shift", "l2", "rs2",
                 "flat", "last")
    g.add_layer("hidden", core.DenseLayer(n_out=5, activation="tanh"), "all")
    g.add_layer("out1", core.OutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"), "hidden")
    g.add_layer("out2", m["rec"].RnnOutputLayer(
        n_out=2, activation="softmax", loss="mcxent"), "dup")
    return g.set_outputs("out1", "out2").build()


def _every_inputs(seed=3, n=4):
    rs = np.random.RandomState(seed)
    x = [rs.randn(n, 6), rs.randn(n, 6), rs.randn(n, 5, 5, 2),
         rs.randn(n, 7, 3)]
    y = [_onehot(rs, n, 3), np.eye(2)[rs.randint(0, 2, (n, 7))]]
    return ([a.astype(np.float32) for a in x],
            [a.astype(np.float32) for a in y])


def _assert_outputs(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_every_vertex_graph_json_and_zip_both_ways(tmp_path):
    """The graph of every vertex: the port's JSON is JAX's and each loads
    in the other; JAX's zip (after two Adam steps) loads in the port and
    the port's zip (after two more) in JAX, outputs within 1e-5 of max|y|
    and the updater state carried."""
    from deeplearning4j_torch.utils import model_serializer as tms
    from deeplearning4j_tpu.utils import model_serializer as jms

    jnet, net = _pair(_every_vertex, "float32")
    tjson = net.conf.to_json()
    assert type(jserde.from_json(tjson)).__name__ == \
        "ComputationGraphConfiguration"
    back = tserde.from_json(jserde.to_json(jnet.conf))
    assert json.loads(back.to_json()) == json.loads(tjson)
    x, y = _every_inputs()
    _assert_outputs(net.output(*x), jnet.output(*x))
    for _ in range(2):
        jnet.do_step(x, y)
    p = str(tmp_path / "jax.zip")
    jms.save_model(jnet, p)
    loaded = tms.load_model(p, device="cpu")
    _assert_outputs(loaded.output(*x), jnet.output(*x))
    assert loaded.iteration == 2
    for _ in range(2):
        loaded.do_step(x, y)
        jnet.do_step(x, y)
    _assert_outputs(loaded.output(*x), jnet.output(*x))
    q = str(tmp_path / "port.zip")
    tms.save_model(loaded, q)
    back = jms.load_model(q)
    _assert_outputs(back.output(*x), loaded.output(*x))
    np.testing.assert_allclose(np.asarray(back.params_flat()),
                               loaded.params_flat(), rtol=0, atol=0)


# ---------------------------------------------------------- C11 call forms
@pytest.mark.parametrize("form", [("adam",), ("adam", 1e-3), ("RmsProp", 0.01),
                                  ("nesterovs",), ("sgd", 0.05)])
def test_updater_by_name_matches_jax(form):
    """``.updater(name[, learning_rate])`` builds JAX's configuration and
    the net trains: ten ``fit`` calls lower the loss."""
    from deeplearning4j_torch.nn.updater import get_updater
    from deeplearning4j_tpu.nn.updater import get_updater as jget

    confs = []
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_torch"):
        m = _mods(pkg)
        confs.append(m["b"].NeuralNetConfiguration.builder().seed(4)
                     .updater(*form).list(
                         m["core"].DenseLayer(n_out=5, activation="tanh"),
                         m["core"].OutputLayer(n_out=3, activation="softmax",
                                               loss="mcxent"))
                     .set_input_type(m["inputs"].InputType.feed_forward(4))
                     .build())
    assert json.loads(confs[1].to_json()) == json.loads(
        jserde.to_json(confs[0]))
    assert tserde.to_jsonable(get_updater(*form)) == \
        jserde.to_jsonable(jget(*form))
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(confs[1]).init(device="cpu")
    rs = np.random.RandomState(0)
    ds = DataSet(rs.randn(16, 4).astype(np.float32),
                 _onehot(rs, 16, 3).astype(np.float32))
    s0 = net.score(ds)
    net.fit(ds, epochs=10)
    assert net.score(ds) < s0
    with pytest.raises(ValueError, match="Unknown updater"):
        get_updater("newton")


def _bn_graph(m, dtype="float32"):
    return (m["b"].NeuralNetConfiguration.builder().seed(8)
            .updater(m["upd"].Sgd(learning_rate=0.1)).dtype(dtype)
            .graph_builder().add_inputs("in")
            .add_layer("d", m["core"].DenseLayer(n_out=6,
                                                 activation="identity"), "in")
            .add_layer("bn", m["norm"].BatchNormalization(), "d")
            .add_layer("out", m["core"].OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "bn")
            .set_outputs("out")
            .set_input_types(m["inputs"].InputType.feed_forward(4)).build())


@pytest.mark.parametrize("n", [4, 5])
def test_graph_output_train_matches_jax(n):
    """``output(x, train=True)``: batch statistics (5 rows bucketed to 8 by
    repeating the last, as JAX pads), the running statistics untouched;
    ``train=False`` uses them. Within 1e-5 of JAX's."""
    jnet, net = _pair(_bn_graph, "float32")
    x = (np.random.RandomState(2).randn(n, 4) * 3 + 1).astype(np.float32)
    before = {k: t.clone() for k, t in net.state["bn"].items()}
    got = net.output(x, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.output(
        x, train=True)), rtol=0, atol=1e-5)
    for k, t in before.items():
        assert torch.equal(net.state["bn"][k], t)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=1e-5)
    assert not np.allclose(got.numpy(), net.output(x).numpy(), atol=1e-3)


def test_add_layer_with_preprocessor_matches_jax():
    """``add_layer(name, layer, *inputs, preprocessor=...)``: JAX's JSON,
    and the preprocessor acts (a flat input reshaped for a convolution)."""
    confs = []
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_torch"):
        m = _mods(pkg)
        confs.append(
            m["b"].NeuralNetConfiguration.builder().seed(1).graph_builder()
            .add_inputs("in")
            .add_layer("conv", m["conv"].ConvolutionLayer(
                n_in=1, n_out=2, kernel_size=(2, 2), activation="relu"),
                "in",
                preprocessor=m["pp"].FeedForwardToCnnPreProcessor(4, 4, 1))
            .add_layer("out", m["core"].OutputLayer(
                n_in=18, n_out=2, activation="softmax", loss="mcxent"),
                "conv",
                preprocessor=m["pp"].CnnToFeedForwardPreProcessor(3, 3, 2))
            .set_outputs("out").build())
    assert json.loads(confs[1].to_json()) == json.loads(
        jserde.to_json(confs[0]))
    jnet = JComputationGraph(confs[0]).init()
    net = ComputationGraph(confs[1]).init(device="cpu")
    params_from_jax(_host(jnet.params), net)
    x = np.random.RandomState(5).randn(3, 16).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=1e-6)


def _bf16_graph(m, dtype="float32"):
    core, I = m["core"], m["inputs"].InputType
    return (m["b"].NeuralNetConfiguration.builder().seed(9)
            .updater(m["upd"].Sgd(learning_rate=0.1)).dtype(dtype)
            .compute_dtype("bfloat16").graph_builder().add_inputs("in")
            .add_layer("d1", core.DenseLayer(n_out=6, activation="tanh"),
                       "in")
            .add_layer("bn", m["norm"].BatchNormalization(), "d1")
            .add_layer("d2", core.DenseLayer(n_out=3, activation="relu"),
                       "in")
            .add_vertex("merge", m["gc"].MergeVertex(), "bn", "d2")
            .add_layer("out", core.OutputLayer(
                n_out=2, activation="softmax", loss="mcxent"), "merge")
            .set_outputs("bn", "merge", "out")
            .set_input_types(I.feed_forward(4)).build())


def test_compute_dtype_follows_jax_through_batch_norm_and_merge():
    """Under ``compute_dtype="bfloat16"`` (the vertices' parameters and
    the inputs cast, as ``_loss`` casts them; here the head too, which
    ``_loss`` runs apart in f32): batch norm computes in bf16 and keeps
    its running statistics in f32, the merge concatenates in bf16, in the
    dtypes JAX's vertices produce; values within bf16 rounding (2^-7 of
    max|a|)."""
    jnet, net = _pair(_bf16_graph, "float32")
    x = np.random.RandomState(4).randn(8, 4).astype(np.float32)
    cast = ("d1", "bn", "d2", "merge", "out")
    tparams = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                   if k in cast else v) for k, v in net.params.items()}
    jparams = {k: (jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                          v) if k in cast else v)
               for k, v in jnet.params.items()}
    new_states: dict = {}
    touts = net._forward(tparams, net.state,
                         [torch.from_numpy(x).to(torch.bfloat16)], None,
                         train=True, new_states=new_states)[0]
    jouts, jstates = jnet._forward(jparams, jnet.state,
                                   [jnp.asarray(x, jnp.bfloat16)], None,
                                   train=True, rng=None)[:2]
    for name, t, j in zip(("bn", "merge", "out"), touts, jouts):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                                   atol=2.0 ** -7 * np.abs(j).max(),
                                   err_msg=name)
    for k in ("mean", "var"):
        assert str(new_states["bn"][k].dtype).split(".")[-1] == \
            str(jstates["bn"][k].dtype) == "float32"
        np.testing.assert_allclose(new_states["bn"][k].numpy(),
                                   np.asarray(jstates["bn"][k]), rtol=2e-2,
                                   atol=1e-3)
