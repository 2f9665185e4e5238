"""Truncated BPTT in the port (``nn/network.py::_fit_tbptt``, routed by both
nets' ``_fit_batch``) against the JAX package's ``fit`` on the CPU, for a
MultiLayerNetwork and a single-input ComputationGraph of the same layers,
on the JAX nets' weights:

- T = 3L + 2 (a ragged last segment), with 3-D labels (GravesLSTM ->
  RnnOutputLayer) and 2-D labels (GravesLSTM -> LastTimeStep ->
  OutputLayer, the labels handed whole to every segment): every segment's
  loss and the parameters after it within rtol 1e-5 of JAX's, in f32 under
  Sgd and in f64 under the zoo model's RmsProp with L2;
- ``fit`` at its defaults (K resolves to 1, the guard on) bit for bit a
  hand-written ``do_step`` loop over the segments with the carry;
- a NaN segment skipped under the guard, mid-sequence and first: the
  losses, the carry after each segment and the parameters as JAX's guard
  leaves them (a mid-sequence skip hands back the carry it was given; a
  first-segment skip has no carry to hand back, so the NaN carry poisons,
  and skips, the rest of that sequence);
- ``tbptt_back_length != tbptt_fwd_length`` refused by the
  MultiLayerConfiguration (builder and JSON) as in JAX; a graph accepts it
  as JAX's graph does, and segments by the forward length;
- ``compute_dtype="bfloat16"`` under ``test_torch_mixed_precision.py``'s
  rule: each segment's loss within rtol 1e-2 of JAX's bf16 losses, the
  first segment's gradients within twice JAX's own bf16 error plus 1e-3
  of max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as tpkg
import deeplearning4j_tpu as jpkg
from deeplearning4j_torch.utils.convert import params_from_jax

pytestmark = pytest.mark.torch_port

L = 4
T = 3 * L + 2
B, N_IN, H, C = 3, 3, 5, 4


def _mods(pkg):
    """The modules a configuration needs, from either package."""
    import importlib

    name = pkg.__name__
    return {m: importlib.import_module(f"{name}.{p}") for m, p in (
        ("b", "nn.conf.builders"), ("it", "nn.conf.inputs"),
        ("rec", "nn.conf.layers.recurrent"), ("core", "nn.conf.layers.core"),
        ("upd", "nn.updater"), ("mln", "nn.multilayer"), ("cg", "nn.graph"),
        ("ds", "datasets.dataset"), ("lis", "optimize.listeners"),
        ("health", "optimize.health"))}


def _layers(m, labels_2d):
    rec = m["rec"]
    if labels_2d:
        return [rec.GravesLSTM(n_out=H, activation="tanh"),
                rec.LastTimeStep(),
                m["core"].OutputLayer(n_out=C, activation="softmax",
                                      loss="mcxent")]
    return [rec.GravesLSTM(n_out=H, activation="tanh"),
            rec.RnnOutputLayer(n_out=C, activation="softmax", loss="mcxent")]


def _conf(m, kind, labels_2d, dtype, updater, back=L, compute_dtype=None):
    g = (m["b"].NeuralNetConfiguration.builder().seed(9)
         .updater(updater(m["upd"])).dtype(dtype))
    if dtype == "float64":
        g = g.l2(1e-3)
    if compute_dtype is not None:
        g = g.compute_dtype(compute_dtype)
    layers = _layers(m, labels_2d)
    if kind == "mln":
        return (g.list(*layers)
                .set_input_type(m["it"].InputType.recurrent(N_IN))
                .backprop_type("tbptt", L, back).build())
    gb = g.graph_builder().add_inputs("in")
    prev = "in"
    for i, layer in enumerate(layers):
        gb.add_layer(f"v{i}", layer, prev)
        prev = f"v{i}"
    return (gb.set_outputs(prev)
            .set_input_types(m["it"].InputType.recurrent(N_IN))
            .backprop_type("tbptt", L, back).build())


SGD = (lambda u: u.Sgd(learning_rate=0.1))
RMSPROP = (lambda u: u.RmsProp(learning_rate=0.01))


def _pair(kind, labels_2d=False, dtype="float32", updater=SGD, back=L,
          compute_dtype=None):
    jm, tm = _mods(jpkg), _mods(tpkg)
    jconf = _conf(jm, kind, labels_2d, dtype, updater, back, compute_dtype)
    tconf = _conf(tm, kind, labels_2d, dtype, updater, back, compute_dtype)
    cls = "mln" if kind == "mln" else "cg"
    net_cls = {"mln": "MultiLayerNetwork", "cg": "ComputationGraph"}[cls]
    jnet = getattr(jm[cls], net_cls)(jconf).init()
    tnet = getattr(tm[cls], net_cls)(tconf).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray,
                                           jax.device_get(jnet.params)), tnet)
    return jnet, tnet


def _data(labels_2d, dtype=np.float32, seed=0, nan_at=None):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, N_IN).astype(dtype)
    if labels_2d:
        y = np.eye(C, dtype=dtype)[rs.randint(0, C, B)]
    else:
        y = np.eye(C, dtype=dtype)[rs.randint(0, C, (B, T))]
    if nan_at is not None:
        x[1, nan_at * L + 1, 0] = np.nan
    return x, y


class _Recorder:
    """Each iteration's loss and flat parameters (either package)."""

    def __init__(self):
        self.losses, self.params = [], []

    def iteration_done(self, model, iteration):
        self.losses.append(float(model.score_value))
        self.params.append(np.array(model.params_flat(), np.float64))

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def _fit_both(jnet, tnet, x, y):
    jr, tr = _Recorder(), _Recorder()
    jnet.set_listeners(jr)
    tnet.set_listeners(tr)
    jnet.fit(_mods(jpkg)["ds"].DataSet(x, y))
    tnet.fit(_mods(tpkg)["ds"].DataSet(x, y))
    return jr, tr


def _assert_segments_close(jr, tr, rtol):
    n_seg = -(-T // L)
    assert len(jr.losses) == len(tr.losses) == n_seg
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=rtol, atol=0)
    for s, (a, b) in enumerate(zip(tr.params, jr.params)):
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max(),
                                   err_msg=f"params after segment {s}")


@pytest.mark.parametrize("labels", ["labels3d", "labels2d"])
@pytest.mark.parametrize("setup", ["f32_sgd", "f64_rmsprop_l2"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_tbptt_fit_matches_jax(kind, setup, labels):
    dtype, updater = {"f32_sgd": ("float32", SGD),
                      "f64_rmsprop_l2": ("float64", RMSPROP)}[setup]
    labels_2d = labels == "labels2d"
    jnet, tnet = _pair(kind, labels_2d, dtype, updater)
    x, y = _data(labels_2d, np.dtype(dtype))
    jr, tr = _fit_both(jnet, tnet, x, y)
    _assert_segments_close(jr, tr, 1e-5)
    assert tnet.iteration == jnet.iteration == 4
    # the carry is dropped at the end of the batch: nothing lands in the
    # layer state
    assert all(not st for st in tnet.state.values())


def _segments(x, y, labels_2d):
    for s in range(-(-T // L)):
        sl = slice(s * L, min((s + 1) * L, T))
        yield x[:, sl], (y if labels_2d else y[:, sl])


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_defaults_bitwise_a_do_step_loop(kind):
    """``fit`` at its defaults (K = 1 under TBPTT, the guard on) runs the
    very steps of a hand-written segment loop."""
    _, a = _pair(kind)
    _, b = _pair(kind)
    x, y = _data(False)
    for _ in range(2):
        a.fit(x, y)
        carry = {}
        for fx, fy in _segments(x, y, False):
            _, carry = b.do_step(fx, fy, carry=carry)
    assert a.iteration == b.iteration == 8
    for v in a.params:
        for k in a.params[v]:
            assert torch.equal(a.params[v][k], b.params[v][k]), (v, k)
    assert float(a.score()) == float(b.score())


def _guarded_loop(net, pkg, x, y):
    """The segment loop under a bound default HealthPolicy: each segment's
    loss and the carry after it, as numpy."""
    policy = _mods(pkg)["health"].HealthPolicy()
    policy.bind(net)
    net._health = policy
    losses, carries = [], []
    carry = {}
    try:
        for fx, fy in _segments(x, y, False):
            loss, carry = net.do_step(fx, fy, carry=carry)
            losses.append(float(loss))
            carries.append({k: {n: np.array(np.asarray(
                t.detach().numpy() if torch.is_tensor(t) else t))
                for n, t in c.items()} for k, c in carry.items()})
    finally:
        net._health = None
    return losses, carries, policy.total_skips


@pytest.mark.parametrize("nan_at", [1, 0], ids=["mid", "first"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_nan_segment_skipped_as_jax_skips_it(kind, nan_at):
    jnet, tnet = _pair(kind)
    x, y = _data(False, nan_at=nan_at)
    jl, jc, jskips = _guarded_loop(jnet, jpkg, x, y)
    tl, tc, tskips = _guarded_loop(tnet, tpkg, x, y)
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    assert tskips == jskips == (1 if nan_at else 4)
    np.testing.assert_allclose(np.nan_to_num(tl), np.nan_to_num(jl),
                               rtol=1e-5)
    for s, (a, b) in enumerate(zip(tc, jc)):
        assert set(a) == set(b)
        for k in b:
            for n in b[k]:
                np.testing.assert_allclose(a[k][n], b[k][n], atol=1e-5,
                                           rtol=0, err_msg=f"{s} {k}.{n}")
    if nan_at:
        # the skipped segment handed back the carry it was given
        for k in jc[0]:
            for n in jc[0][k]:
                np.testing.assert_array_equal(tc[1][k][n], tc[0][k][n])
    got = tnet.params_flat()
    want = np.asarray(jnet.params_flat())
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_back_length_other_than_fwd_refused_as_in_jax():
    from deeplearning4j_torch.nn.conf.builders import MultiLayerConfiguration

    jm, tm = _mods(jpkg), _mods(tpkg)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="tbptt_back_length"):
            _conf(m, "mln", False, "float32", SGD, back=L - 1)
    ok = _conf(tm, "mln", False, "float32", SGD)
    bad = ok.to_json().replace(f'"tbptt_back_length": {L}',
                               f'"tbptt_back_length": {L - 1}')
    assert bad != ok.to_json()
    with pytest.raises(ValueError, match="tbptt_back_length"):
        MultiLayerConfiguration.from_json(bad)


def test_graph_accepts_back_length_and_segments_by_fwd_as_jax():
    """JAX's graph configuration takes any back length and segments by the
    forward length; so does the port's."""
    jnet, tnet = _pair("graph", back=L - 1)
    assert tnet.conf.tbptt_back_length == jnet.conf.tbptt_back_length == L - 1
    x, y = _data(False)
    jr, tr = _fit_both(jnet, tnet, x, y)
    _assert_segments_close(jr, tr, 1e-5)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_bf16_compute_tbptt_under_the_mixed_precision_rule(kind):
    jnet, tnet = _pair(kind, compute_dtype="bfloat16")
    j32, _ = _pair(kind)
    x, y = _data(False)
    fx, fy = next(_segments(x, y, False))

    def jgrads(net):
        def loss(p):
            return net._loss(p, net.state, jnp.asarray(fx), jnp.asarray(fy),
                             None, None, train=True, rng=None, carry={})[0]
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jax.grad(loss)(net.params))

    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    ref = jgrads(j32)
    jbf = jgrads(jnet)
    _, tg = value_and_grad(tnet, tnet.params, tnet.state,
                           torch.from_numpy(fx), torch.from_numpy(fy),
                           train=True, carry={})
    for v in ref:
        for k in ref[v]:
            r = ref[v][k]
            own = np.abs(jbf[v][k] - r).max()
            got = tg[v][k].double().numpy()
            assert np.abs(got - r).max() <= 2 * own + 1e-3 * np.abs(r).max(), \
                (v, k)
    jr, tr = _fit_both(jnet, tnet, x, y)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-2)
    assert all(t.dtype == torch.float32 for p in tnet.params.values()
               for t in p.values())
