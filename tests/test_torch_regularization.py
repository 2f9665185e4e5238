"""Port parity of the training fields of the JAX conf, on the CPU: L1/L2
regularization (``nn/regularization.py``), the six gradient-normalization
modes (``nn/gradient_normalization.py``), per-layer learning rates
(``ComputationGraph._lr_mult_tree``), input dropout
(``Layer.apply_input_dropout`` with one key per vertex) and ``remat``.

A TransformerLM at the committed fixture's width (vocab 7, d_model 16, two
heads of 8) is built by both packages from the same JAX weights, the field
set on the same layers, and trained three Adam steps through ``fit``
(``fused_steps=1``, guard off): losses within rtol 1e-5 and every
parameter within 1e-5 of the largest |param|. The dropout masks are JAX's
bit for bit (the same ``bernoulli`` calls, in the same order, with the same
keys); ``remat=True`` trains bit for bit as ``remat=False``; a graph built
over a global configuration inherits its fields as JAX's does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JaxDataSet)
from deeplearning4j_tpu.models.zoo import (  # noqa: E402
    TransformerLM as JaxTransformerLM)
from deeplearning4j_tpu.nn.graph import (  # noqa: E402
    ComputationGraph as JaxGraph)
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_torch.ops import random as tr  # noqa: E402
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    params_from_jax, params_to_numpy)

pytestmark = pytest.mark.torch_port

V = 7
KW = dict(num_labels=V, max_length=8, d_model=16, n_heads=2, n_blocks=1)
MODES = ["renormalize_l2_per_layer", "renormalize_l2_per_param_type",
         "clip_element_wise_absolute_value", "clip_l2_per_layer",
         "clip_l2_per_param_type"]


def _set(**fields):
    def edit(name, layer):
        for k, v in fields.items():
            setattr(layer, k, v)
    return edit


def _on(names, **fields):
    def edit(name, layer):
        if name in names:
            for k, v in fields.items():
                setattr(layer, k, v)
    return edit


#: case -> edit(vertex name, layer), applied to both packages' confs
CASES = {
    "l1": _set(l1=1e-3),
    "l2": _set(l2=5e-2),
    "l1_bias_l2_bias": _set(l1_bias=1e-3, l2_bias=5e-2),
    **{m: _set(gradient_normalization=m,
               gradient_normalization_threshold=0.05) for m in MODES},
    "learning_rate": _on({"output", "embed"}, learning_rate=3e-3,
                         bias_learning_rate=1e-2),
    "dropout": _on({"ff0a", "attn0", "output"}, dropout=0.25),
}


def _nets(edit=None, remat=False, seed=5):
    jconf = JaxTransformerLM(seed=seed, remat=remat, **KW).conf()
    tconf = TransformerLM(seed=seed, remat=remat, max_cache=32, **KW).conf()
    for conf in (jconf, tconf):
        for name, v in conf.vertices.items():
            layer = getattr(v, "layer", None)
            if edit is not None and layer is not None and \
                    hasattr(layer, "l1"):
                edit(name, layer)
    j = JaxGraph(jconf).init()
    t = ComputationGraph(tconf).init(device="cpu")
    params_from_jax(jax.device_get(j.params), t)
    return j, t


def _batch(seed=1, B=3):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, V, (B, KW["max_length"] + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[tok[:, :-1]], eye[tok[:, 1:]]


def _params_close(j, t):
    ref = jax.device_get(j.params)
    got = params_to_numpy(t)
    scale = max(np.abs(a).max() for p in ref.values() for a in p.values())
    for v in ref:
        for k in ref[v]:
            np.testing.assert_allclose(got[v][k], np.asarray(ref[v][k]),
                                       atol=1e-5 * scale, rtol=0,
                                       err_msg=f"{v}.{k}")


@pytest.mark.parametrize("case", list(CASES))
def test_three_adam_steps_match_jax(case):
    j, t = _nets(CASES[case])
    x, y = _batch()
    jl, tl = [], []
    for _ in range(3):
        j.fit(JaxDataSet(x, y), fused_steps=1, health_guard=None)
        t.fit(DataSet(x, y), fused_steps=1, health_guard=None)
        jl.append(float(j.score_value))
        tl.append(t.score())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert t.iteration == j.iteration == 3
    _params_close(j, t)


def test_penalty_is_reported_not_differentiated():
    """The reported loss carries the L1/L2 penalty (JAX's value); the
    gradient of ``_loss`` does not (the step adds the closed form)."""
    from deeplearning4j_torch.nn.regularization import penalty_value
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    j, t = _nets(_set(l1=1e-3, l2=5e-2))
    _, plain = _nets()
    x, y = _batch(2)
    from deeplearning4j_tpu.nn.regularization import penalty_value as jpen

    assert float(penalty_value(t, t.params)) == pytest.approx(
        float(jpen(j, j.params)), rel=1e-5)
    xs, ys = [torch.from_numpy(x)], [torch.from_numpy(y)]
    loss, g = value_and_grad(t, t.params, t.state, xs, ys)
    loss0, g0 = value_and_grad(plain, plain.params, plain.state, xs, ys)
    assert float(loss) == pytest.approx(
        float(loss0) + float(penalty_value(t, t.params)), rel=1e-6)
    for v in g:
        for k in g[v]:
            assert torch.equal(g[v][k], g0[v][k]), (v, k)


def test_dropout_masks_are_jax_bitwise(monkeypatch):
    """A training forward with dropout on a Dense, an attention and the
    output vertex draws the masks JAX draws: the same ``bernoulli`` calls
    in the topo order, each with the key of its vertex's index in
    ``split(rng, len(topo_order))``, equal bit for bit; no draw at
    inference."""
    j, t = _nets(CASES["dropout"])
    x, _ = _batch(3)
    seen = {"jax": [], "port": []}
    jax_bernoulli, port_bernoulli = jax.random.bernoulli, tr.bernoulli

    def jrec(key, p, shape):
        m = jax_bernoulli(key, p, shape)
        seen["jax"].append((tuple(shape), np.asarray(m)))
        return m

    def trec(key, p, shape):
        m = port_bernoulli(key, p, shape)
        seen["port"].append((tuple(shape), m.numpy()))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", jrec)
    monkeypatch.setattr(tr, "bernoulli", trec)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    tkey = tr.fold_in(tr.PRNGKey(5, device="cpu"), 2)
    j._forward(j.params, j.state, [jnp.asarray(x)], [None], train=True,
               rng=jkey)
    with torch.no_grad():
        t._forward(t.params, t.state, [torch.from_numpy(x)], [None],
                   train=True, rng=tkey)
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for (js, jm), (ts, tm) in zip(seen["jax"], seen["port"]):
        assert js == ts
        np.testing.assert_array_equal(tm, jm)
        assert 0.6 < tm.mean() < 0.9
    seen["port"].clear()
    t.output(x)
    assert seen["port"] == []


@pytest.mark.parametrize("dropout", [False, True])
def test_remat_equals_no_remat_bitwise(dropout):
    """``remat=True`` recomputes the attention and FFN vertices in the
    backward (``torch.utils.checkpoint``) and trains bit for bit as
    without it, dropout included (the recompute redraws the same mask from
    its explicit key)."""
    edit = CASES["dropout"] if dropout else None
    _, a = _nets(edit, remat=False)
    _, b = _nets(edit, remat=True)
    assert b.conf.vertices["attn0"].remat and b.conf.vertices["ff0a"].remat
    x, y = _batch(4)
    for _ in range(3):
        la = float(a.do_step([x], [y])[0])
        lb = float(b.do_step([x], [y])[0])
        assert la == lb
    for v in a.params:
        for k in a.params[v]:
            assert torch.equal(a.params[v][k], b.params[v][k]), (v, k)


def test_global_conf_inheritance_matches_jax():
    """A graph built over a global configuration (L1/L2, dropout, gradient
    normalization, weight init, activation) gives every layer the fields
    JAX's build gives it, and ``layer_map_for`` maps them alike."""
    from deeplearning4j_tpu.nn.conf.builders import (
        NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.conf.layers import (DenseLayer as JDense,
                                                   OutputLayer as JOut)
    from deeplearning4j_tpu.nn.gradient_normalization import (
        layer_map_for as jmap)
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.nn.gradient_normalization import layer_map_for

    def build(NNC, IT, Dense, Out):
        return (NNC.builder().seed(3).l1(1e-4).l2(2e-3).dropout(0.1)
                .weight_init("relu").activation("tanh")
                .gradient_normalization("clip_l2_per_layer")
                .gradient_normalization_threshold(0.7)
                .graph_builder().add_inputs("in")
                .add_layer("d1", Dense(n_out=8), "in")
                .add_layer("d2", Dense(n_out=8, l2=0.5, dropout=0.0,
                                       gradient_normalization="none"), "d1")
                .add_layer("out", Out(n_out=3, activation="softmax"), "d2")
                .set_outputs("out")
                .set_input_types(IT.feed_forward(4)).build())

    jc = build(JNNC, JIT, JDense, JOut)
    tc = build(NeuralNetConfiguration, InputType, DenseLayer, OutputLayer)
    fields = ("activation", "weight_init", "l1", "l2", "l1_bias", "l2_bias",
              "dropout", "gradient_normalization",
              "gradient_normalization_threshold", "n_in", "n_out")
    for name in ("d1", "d2", "out"):
        for f in fields:
            assert getattr(tc.vertices[name].layer, f) == \
                getattr(jc.vertices[name].layer, f), (name, f)
    assert tc.seed == jc.seed == 3
    jm = jmap(JaxGraph(jc))
    tm = layer_map_for(ComputationGraph(tc))
    assert sorted(tm) == sorted(jm)
    assert [tm[k].gradient_normalization for k in sorted(tm)] == \
        [jm[k].gradient_normalization for k in sorted(jm)]
