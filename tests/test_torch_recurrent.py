"""The port's recurrent layers and rnn vertices against the JAX package's
(``nn/conf/layers/recurrent.py``, ``nn/conf/graph_conf.py``) on the CPU, on
the same numpy-seeded inputs and the JAX layers' own weights:

- LSTM, GravesLSTM, GravesBidirectionalLSTM and SimpleRnn, masked (ragged
  rows and a row with a hole) and unmasked, with and without an initial
  h/c: the f32 outputs and final state within 1e-5, and the f64 gradients
  of every parameter and of the input within 1e-8 of the leaf's max|g|
  against ``jax.grad``;
- a NaN at a masked step propagates as JAX's carry-through arithmetic
  propagates it;
- LastTimeStep (no mask, ragged, non-contiguous and all-masked rows);
- LastTimeStepVertex (its own mask and a network input's by
  ``mask_input``) and DuplicateToTimeSeriesVertex inside a graph, forward
  and gradients against the JAX graph;
- the bidirectional layer's L1/L2 split: the penalty value and its
  closed-form gradient (peepholes and weights take l1/l2, ``f_b``/``b_b``
  the bias coefficients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn.conf.layers import recurrent as trec
from deeplearning4j_tpu.nn.conf.layers import recurrent as jrec

pytestmark = pytest.mark.torch_port

B, T, N_IN, H = 3, 6, 3, 4
STATEFUL = ("LSTM", "GravesLSTM", "SimpleRnn")
LAYERS = STATEFUL + ("GravesBidirectionalLSTM",)


def _mask():
    m = np.ones((B, T), np.float32)
    m[1, 4:] = 0.0          # a ragged row
    m[2, 1] = m[2, 3] = 0.0  # holes
    return m


def _layers(name, **kw):
    """The JAX and port layer ``name`` with the same fields, finalized."""
    j = getattr(jrec, name)(n_in=N_IN, n_out=H, activation="tanh", **kw)
    t = getattr(trec, name)(n_in=N_IN, n_out=H, activation="tanh", **kw)
    j.finalize()
    t.finalize()
    return j, t


def _params(jlayer, dtype, seed=0):
    """The JAX layer's init, with nonzero peepholes (they start at zero)."""
    p = {k: np.array(v, dtype) for k, v in
         jlayer.init_params(jax.random.PRNGKey(seed)).items()}
    rs = np.random.RandomState(seed + 1)
    for k in p:
        if k.split("_")[-1] in ("pi", "pf", "po"):
            p[k] = (0.3 * rs.randn(*p[k].shape)).astype(dtype)
    return p


def _inputs(dtype, masked, stateful, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, N_IN).astype(dtype)
    mask = _mask().astype(dtype) if masked else None
    state = ({"h": (0.5 * rs.randn(B, H)).astype(dtype),
              "c": (0.5 * rs.randn(B, H)).astype(dtype)}
             if stateful else {})
    return x, mask, state


def _run_jax(layer, p, state, x, mask):
    out, ns = layer.forward({k: jnp.asarray(v) for k, v in p.items()},
                            {k: jnp.asarray(v) for k, v in state.items()},
                            jnp.asarray(x),
                            mask=None if mask is None else jnp.asarray(mask))
    return np.asarray(out), {k: np.asarray(v) for k, v in ns.items()}


def _run_port(layer, p, state, x, mask):
    out, ns = layer.forward({k: torch.from_numpy(v) for k, v in p.items()},
                            {k: torch.from_numpy(v)
                             for k, v in state.items()},
                            torch.from_numpy(x),
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    return out.numpy(), {k: v.numpy() for k, v in ns.items()}


@pytest.mark.parametrize("stateful", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", LAYERS)
def test_forward_f32_matches_jax(name, masked, stateful):
    jl, tl = _layers(name)
    p = _params(jl, np.float32)
    x, mask, state = _inputs(np.float32, masked, stateful)
    jo, js = _run_jax(jl, p, state, x, mask)
    to, ts = _run_port(tl, p, state, x, mask)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    if name == "GravesBidirectionalLSTM":
        # the state passes through; no carry
        assert set(ts) == set(state)
    else:
        assert {"h"} <= set(ts)


def _loss_weights(shape, seed=5):
    return np.random.RandomState(seed).randn(*shape)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", LAYERS)
def test_gradients_f64_match_jax(name, masked):
    """d/d(params, x) of sum(out·w) + sum(h_T·w_h) (+ c_T) in f64."""
    jl, tl = _layers(name)
    p = _params(jl, np.float64)
    x, mask, state = _inputs(np.float64, masked, name in STATEFUL)
    w = _loss_weights((B, T, H))
    wh = _loss_weights((B, H), seed=6)

    def jloss(pp, xx):
        out, ns = jl.forward(pp, {k: jnp.asarray(v) for k, v in
                                  state.items()}, xx,
                             mask=None if mask is None else jnp.asarray(mask))
        total = jnp.sum(out * w)
        for k in ("h", "c"):
            if k in ns and k in state:
                total = total + jnp.sum(ns[k] * wh)
        return total

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, ns = tl.forward(tp, {k: torch.from_numpy(v) for k, v in
                              state.items()}, tx,
                         mask=None if mask is None else torch.from_numpy(mask))
    total = (out * torch.from_numpy(w)).sum()
    for k in ("h", "c"):
        if k in ns and k in state:
            total = total + (ns[k] * torch.from_numpy(wh)).sum()
    total.backward()
    want = dict(jg_p, x=jg_x)
    got = {k: t.grad for k, t in tp.items()}
    got["x"] = tx.grad
    for k, g in want.items():
        g = np.asarray(g)
        np.testing.assert_allclose(got[k].numpy(), g, rtol=0,
                                   atol=1e-8 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("name", STATEFUL)
def test_nan_at_a_masked_step_propagates_as_in_jax(name):
    """Carry-through is arithmetic, ``m·h + (1 − m)·h_prev``: a NaN input
    at a masked step reaches the carry as it does in JAX."""
    jl, tl = _layers(name)
    p = _params(jl, np.float32)
    x, mask, state = _inputs(np.float32, True, False)
    x[2, 1, 0] = np.nan                  # row 2, step 1 is masked
    jo, js = _run_jax(jl, p, state, x, mask)
    to, ts = _run_port(tl, p, state, x, mask)
    np.testing.assert_array_equal(np.isnan(to), np.isnan(jo))
    assert np.isnan(jo[2]).any() and not np.isnan(jo[:2]).any()
    np.testing.assert_allclose(to[:2], jo[:2], atol=1e-5, rtol=0)


def test_last_time_step_matches_jax():
    jl, tl = jrec.LastTimeStep(), trec.LastTimeStep()
    x = np.random.RandomState(3).randn(4, T, H).astype(np.float32)
    m = np.ones((4, T), np.float32)
    m[1, 3:] = 0.0                       # ragged: step 2
    m[2] = [1, 0, 1, 1, 0, 0]            # non-contiguous: step 3
    m[3] = 0.0                           # all masked: step 0
    for mask in (None, m):
        jo, _ = jl.forward({}, {}, jnp.asarray(x),
                           mask=None if mask is None else jnp.asarray(mask))
        to, _ = tl.forward({}, {}, torch.from_numpy(x),
                           mask=None if mask is None
                           else torch.from_numpy(mask))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy(), x[[0, 1, 2, 3], [5, 2, 3, 0]])
    assert tl.feed_forward_mask(torch.from_numpy(m)) is None


def _vertex_graphs(dtype, mask_input):
    """The JAX and port graph in -> GravesLSTM -> LastTimeStepVertex ->
    DuplicateToTimeSeriesVertex -> RnnOutputLayer, the port on the JAX
    net's weights."""
    from deeplearning4j_torch.nn.conf import graph_conf as tg
    from deeplearning4j_torch.nn.conf.builders import (
        NeuralNetConfiguration as TNNC)
    from deeplearning4j_torch.nn.conf.inputs import InputType as TIT
    from deeplearning4j_torch.nn.graph import ComputationGraph as TCG
    from deeplearning4j_torch.utils.convert import params_from_jax
    from deeplearning4j_tpu.nn.conf import graph_conf as jg
    from deeplearning4j_tpu.nn.conf.builders import (
        NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG

    def conf(NNC, IT, rec, g):
        return (NNC.builder().seed(4).dtype(dtype).graph_builder()
                .add_inputs("in")
                .add_layer("lstm", rec.GravesLSTM(n_out=H,
                                                  activation="tanh"), "in")
                .add_vertex("last", g.LastTimeStepVertex(
                    mask_input="in" if mask_input else None), "lstm")
                .add_vertex("dup", g.DuplicateToTimeSeriesVertex(
                    input_name="in"), "last")
                .add_layer("out", rec.RnnOutputLayer(n_out=2), "dup")
                .set_outputs("out")
                .set_input_types(IT.recurrent(N_IN))
                .build())

    jnet = JCG(conf(JNNC, JIT, jrec, jg)).init()
    tnet = TCG(conf(TNNC, TIT, trec, tg)).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray,
                                           jax.device_get(jnet.params)), tnet)
    return jnet, tnet


@pytest.mark.parametrize("mask_input", [False, True],
                         ids=["own_mask", "mask_input"])
def test_rnn_vertices_in_a_graph_match_jax(mask_input):
    """Forward (f32, within 1e-5) and the f64 loss gradients (within 1e-8
    of max|g|) of a masked batch through both vertices."""
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    rs = np.random.RandomState(7)
    x = rs.randn(B, T, N_IN).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (B, T))]
    m = _mask()
    jnet, tnet = _vertex_graphs("float32", mask_input)
    np.testing.assert_allclose(tnet.output(x, masks=[m]).numpy(),
                               np.asarray(jnet.output(x, masks=[m])),
                               atol=1e-5, rtol=0)
    # the duplicated step is the last active one of each row
    acts = tnet.feed_forward(x)
    np.testing.assert_array_equal(acts["dup"].numpy(),
                                  np.repeat(acts["last"].numpy()[:, None],
                                            T, axis=1))
    jnet, tnet = _vertex_graphs("float64", mask_input)
    x64, y64, m64 = x.astype(np.float64), y.astype(np.float64), m
    (_, _), jg = jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, [jnp.asarray(x64)],
                             [jnp.asarray(y64)], [jnp.asarray(m64)], None,
                             train=False, rng=None), has_aux=True)(jnet.params)
    _, tg = value_and_grad(tnet, tnet.params, tnet.state,
                           [torch.from_numpy(x64)], [torch.from_numpy(y64)],
                           [torch.from_numpy(m64)])
    for v in jg:
        for k, g in jg[v].items():
            g = np.asarray(g)
            np.testing.assert_allclose(tg[v][k].numpy(), g, rtol=0,
                                       atol=1e-8 * np.abs(g).max(),
                                       err_msg=f"{v}.{k}")


def test_bidirectional_penalty_matches_jax():
    """l1/l2 on the weights and peepholes, l1_bias/l2_bias on f_b and b_b:
    the penalty value and its closed-form gradient equal JAX's."""
    kw = dict(l1=0.01, l2=0.05, l1_bias=0.002, l2_bias=0.03)
    jl, tl = _layers("GravesBidirectionalLSTM", **kw)
    assert tl.bias_param_names() == jl.bias_param_names() == {"f_b", "b_b"}
    p = _params(jl, np.float64)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    assert float(tl.regularization(tp)) == pytest.approx(
        float(jl.regularization(jp)), rel=1e-12)
    want = jl.regularization_grad(jp)
    got = tl.regularization_grad(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=0, err_msg=k)
    # the biases took the bias coefficients, the peepholes the others
    np.testing.assert_allclose(got["f_b"].numpy(),
                               0.03 * p["f_b"] + 0.002 * np.sign(p["f_b"]))
    np.testing.assert_allclose(got["b_pi"].numpy(),
                               0.05 * p["b_pi"] + 0.01 * np.sign(p["b_pi"]))


@pytest.mark.parametrize("name", LAYERS + ("LastTimeStep",))
def test_param_order_and_init_shapes_match_jax(name):
    """The flat-vector order and every parameter's shape are JAX's; the
    forget-gate block of the LSTM bias starts at forget_gate_bias_init."""
    jl, tl = ((jrec.LastTimeStep(), trec.LastTimeStep())
              if name == "LastTimeStep" else _layers(name))
    assert tl.param_order() == jl.param_order()
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = tl.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in tp:
        if k.split("_")[-1] == "b" and name != "SimpleRnn":
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # no draw (a zip's weights replace it): zeros where JAX draws
    zeros = tl.init_params(None)
    assert all(not zeros[k].any() for k in zeros if k.endswith("W"))


def _zoo_of_layers(pkg):
    """A MultiLayerNetwork of every recurrent layer class and a graph of
    both rnn vertices, from ``pkg``'s classes."""
    import importlib

    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    it = importlib.import_module(f"{pkg}.nn.conf.inputs")
    rec = importlib.import_module(f"{pkg}.nn.conf.layers.recurrent")
    core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
    g = importlib.import_module(f"{pkg}.nn.conf.graph_conf")
    upd = importlib.import_module(f"{pkg}.nn.updater")
    mln = (b.NeuralNetConfiguration.builder().seed(2).l2(1e-3)
           .updater(upd.RmsProp(learning_rate=0.01))
           .list(rec.LSTM(n_out=5), rec.GravesLSTM(n_out=4),
                 rec.SimpleRnn(n_out=4),
                 rec.GravesBidirectionalLSTM(n_out=3), rec.LastTimeStep(),
                 core.OutputLayer(n_out=2))
           .set_input_type(it.InputType.recurrent(N_IN))
           .t_bptt_lengths(4).build())
    graph = (b.NeuralNetConfiguration.builder().seed(2)
             .updater(upd.RmsProp(learning_rate=0.01))
             .graph_builder().add_inputs("in")
             .add_layer("lstm", rec.GravesLSTM(n_out=4), "in")
             .add_vertex("last", g.LastTimeStepVertex(mask_input="in"),
                         "lstm")
             .add_vertex("dup", g.DuplicateToTimeSeriesVertex(
                 input_name="in"), "last")
             .add_layer("out", rec.RnnOutputLayer(n_out=2), "dup")
             .set_outputs("out").set_input_types(it.InputType.recurrent(N_IN))
             .t_bptt_lengths(4).build())
    return mln, graph


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_zip_of_every_recurrent_class_both_ways(kind, tmp_path):
    """Every layer and vertex class registered under JAX's name: a JAX zip
    (after a TBPTT fit, so it carries RmsProp state) loads in the port
    with its coefficients byte for byte, the bidirectional layer's
    ``f_*`` then ``b_*`` order, the same updater state and the same
    output; the port's zip of it loads back in JAX, bytes equal."""
    import zipfile

    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.utils import model_serializer as tms
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.utils import model_serializer as jms

    jconf = _zoo_of_layers("deeplearning4j_tpu")[kind == "graph"]
    jnet = (JMLN if kind == "mln" else JCG)(jconf).init()
    rs = np.random.RandomState(1)
    x = rs.randn(B, 9, N_IN).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, B if kind == "mln"
                                               else (B, 9))]
    jnet.fit(JDataSet(x, y))
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jms.save_model(jnet, jpath)
    tnet = tms.load_model(jpath, device="cpu")
    assert type(tnet).__name__ == type(jnet).__name__
    with zipfile.ZipFile(jpath) as zf:
        coeff = zf.read("coefficients.bin")
    assert tnet.params_flat().astype("<f4").tobytes() == coeff
    if kind == "mln":
        assert tnet.layers[3].param_order()[:6] == [
            "f_W", "f_RW", "f_b", "f_pi", "f_pf", "f_po"]
        assert tnet.conf.tbptt_fwd_length == 4
    else:
        assert tnet.conf.vertices["last"].mask_input == "in"
        assert tnet.conf.vertices["dup"].input_name == "in"
    for k, p in jnet.updater_state["h"].items():
        for n, h in p.items():
            np.testing.assert_array_equal(
                tnet.updater_state["h"][k][n].numpy(), np.asarray(h))
    m = _mask()
    m = np.concatenate([m, np.ones((B, 3), np.float32)], 1)
    kw = (dict(mask=m) if kind == "mln" else dict(masks=[m]))
    np.testing.assert_allclose(tnet.output(x, **kw).numpy(),
                               np.asarray(jnet.output(x, **kw)),
                               atol=1e-5, rtol=0)
    tnet.fit(DataSet(x, y))
    assert tnet.iteration == 2 * 3
    tms.save_model(tnet, tpath)
    back = jms.load_model(tpath)
    assert np.asarray(back.params_flat()).astype("<f4").tobytes() == \
        tnet.params_flat().astype("<f4").tobytes()
