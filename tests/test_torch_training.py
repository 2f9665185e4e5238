"""Port parity of the training slice: the updaters, the mcxent loss head and
a small ``TransformerLM`` trained through the port's ``do_step``/``fit``,
against the JAX package on the same numpy-drawn inputs and weights.

Tolerances, all f32:

- updaters: one step, ``max|Δ| ≤ 1e-6`` on the step and on every state slot
  (the formulas are the same; XLA and PyTorch round the f32 scalars and
  powers in their own way);
- mcxent per-example loss: atol 1e-5 (log-softmax reduced in another order);
- gradients of ``_loss``: ``max|Δ| ≤ 1e-4·max|g|`` per leaf, with JAX's
  attention on its default CPU route (``scaled_dot_attention``) and on
  ``helper="pallas"`` (the Pallas flash forward and backward in interpret
  mode); the port takes its flash plain versions on the CPU;
- three Sgd steps: losses and parameters within atol 1e-5;
- three Adam steps: losses within rtol 1e-4. Adam's first step moves each
  parameter by about ``lr·sign(g)``, so a near-zero gradient whose sign
  differs between XLA and PyTorch moves it by up to ``2·lr``: parameters
  after Adam are not held elementwise;
- updater state carried from JAX and back: exact.
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
from deeplearning4j_tpu.nn import updater as jup  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers.recurrent import (  # noqa: E402
    RnnOutputLayer as JaxRnnOutputLayer)
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.nn import updater as tup  # noqa: E402
from deeplearning4j_torch.nn.conf.layers.recurrent import (  # noqa: E402
    RnnOutputLayer)
from deeplearning4j_torch.optimize.fused_fit import (  # noqa: E402
    value_and_grad)
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    params_from_jax, params_to_numpy, updater_state_from_jax,
    updater_state_to_numpy)

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

V = 17
KW = dict(num_labels=V, max_length=16, d_model=32, n_heads=4, n_blocks=2)


# ---------------------------------------------------------------- updaters
UPDATERS = {
    "sgd": dict(learning_rate=0.05),
    "noop": dict(),
    "nesterovs": dict(learning_rate=0.05, momentum=0.9),
    "adam": dict(learning_rate=1e-3),
    "adamax": dict(learning_rate=2e-3),
    "nadam": dict(learning_rate=1e-3),
    "adagrad": dict(learning_rate=0.1),
    "rmsprop": dict(learning_rate=0.01),
    "adadelta": dict(),
}
_JCLS = {"sgd": jup.Sgd, "noop": jup.NoOp, "nesterovs": jup.Nesterovs,
         "adam": jup.Adam, "adamax": jup.AdaMax, "nadam": jup.Nadam,
         "adagrad": jup.AdaGrad, "rmsprop": jup.RmsProp,
         "adadelta": jup.AdaDelta}
_TCLS = {"sgd": tup.Sgd, "noop": tup.NoOp, "nesterovs": tup.Nesterovs,
         "adam": tup.Adam, "adamax": tup.AdaMax, "nadam": tup.Nadam,
         "adagrad": tup.AdaGrad, "rmsprop": tup.RmsProp,
         "adadelta": tup.AdaDelta}
SCHEDULES = {
    "exponential": dict(policy="exponential", decay_rate=0.9),
    "inverse": dict(policy="inverse", decay_rate=0.1, power=0.75),
    "poly": dict(policy="poly", power=2.0, max_iterations=20),
    "sigmoid": dict(policy="sigmoid", decay_rate=0.5, steps=3.0),
    "step": dict(policy="step", decay_rate=0.5, steps=2.0),
    "schedule": dict(policy="schedule", schedule={"0": 0.05, "3": 0.01}),
}


def _tree(rs, scale=1.0, positive=False):
    shapes = {"a": {"W": (5, 3), "b": (3,)}, "b": {"gamma": (4,)}}
    out = {}
    for v, p in shapes.items():
        out[v] = {}
        for k, shp in p.items():
            a = rs.randn(*shp).astype(np.float32) * scale
            out[v][k] = np.abs(a) if positive else a
    return out


def _state_for(name, rs, fresh):
    """Updater state drawn with numpy: zeros at iteration 0, else random
    (non-negative where the slot is a running square or max)."""
    slots = {"nesterovs": ["v"], "adam": ["m", "v"], "adamax": ["m", "u"],
             "nadam": ["m", "v"], "adagrad": ["h"], "rmsprop": ["h"],
             "adadelta": ["eg", "ex"]}.get(name, [])
    positive = {"v", "u", "h", "eg", "ex"}
    out = {}
    for s in slots:
        t = _tree(rs, 0.1, positive=(s in positive and name != "nesterovs"))
        out[s] = ({v: {k: np.zeros_like(a) for k, a in p.items()}
                   for v, p in t.items()} if fresh else t)
    return out


def _check_step(jupd, tupd, iteration, seed, lr_mult=1.0):
    rs = np.random.RandomState(seed)
    grads = _tree(rs, 0.3)
    state = _state_for(type(jupd).__name__.lower()
                       if type(jupd) is not jup.NoOp else "noop", rs,
                       fresh=(iteration == 0))
    jst, jstate = jupd.step(jax.tree_util.tree_map(jnp.asarray, grads),
                            jax.tree_util.tree_map(jnp.asarray, state),
                            jnp.asarray(iteration, jnp.float32), lr_mult)
    to_t = lambda tr: {v: {k: torch.from_numpy(np.array(a))  # noqa: E731
                           for k, a in p.items()} for v, p in tr.items()}
    tst, tstate = tupd.step(to_t(grads), {s: to_t(t) for s, t in
                                          state.items()}, iteration, lr_mult)
    pairs = [(jst, tst)] + [(jstate[s], tstate[s]) for s in jstate]
    assert set(jstate) == set(tstate)
    for jt, tt in pairs:
        for v in jt:
            for k in jt[v]:
                got = tt[v][k]
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(jt[v][k]),
                                           atol=1e-6, rtol=0,
                                           err_msg=f"{v}.{k}")


@pytest.mark.parametrize("iteration", [0, 5])
@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_step_matches_jax(name, iteration):
    kw = UPDATERS[name]
    _check_step(_JCLS[name](**kw), _TCLS[name](**kw), iteration,
                seed=sorted(UPDATERS).index(name) * 7 + iteration)


@pytest.mark.parametrize("policy", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(policy):
    kw = SCHEDULES[policy]
    jupd = jup.Adam(learning_rate=1e-3,
                    lr_schedule=jup.LearningRateSchedule(**kw))
    tupd = tup.Adam(learning_rate=1e-3,
                    lr_schedule=tup.LearningRateSchedule(**kw))
    for it in (0, 1, 4, 7):
        np.testing.assert_allclose(
            float(tupd.lr(it)),
            float(jupd.lr(jnp.asarray(it, jnp.float32))), rtol=1e-6)
    _check_step(jupd, tupd, 4, seed=100 + sorted(SCHEDULES).index(policy))


@pytest.mark.parametrize("name", ["sgd", "nesterovs", "adam"])
def test_per_leaf_lr_multipliers_match_jax(name):
    mult = {"a": {"W": 0.5, "b": 2.0}, "b": {"gamma": 0.0}}
    kw = UPDATERS[name]
    _check_step(_JCLS[name](**kw), _TCLS[name](**kw), 3, seed=200,
                lr_mult=mult)


def test_updater_init_and_scale_lr():
    params = {"a": {"W": torch.ones(2, 3)}}
    st = tup.Adam().init(params)
    assert set(st) == {"m", "v"} and torch.equal(st["m"]["a"]["W"],
                                                 torch.zeros(2, 3))
    assert tup.Sgd().init(params) == {}
    u = tup.Sgd(learning_rate=0.1)
    assert u.scale_lr(0.5) == pytest.approx(0.05)
    with pytest.raises(ValueError):
        u.scale_lr(0.0)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_mcxent_per_example_matches_jax(masked):
    from deeplearning4j_tpu.ops.losses import get_loss as jax_loss
    from deeplearning4j_torch.ops.losses import get_loss

    rs = np.random.RandomState(3)
    W = rs.randn(6, V).astype(np.float32)
    b = rs.randn(V).astype(np.float32)
    x = rs.randn(3, 5, 6).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rs.randint(0, V, (3, 5))]
    jl = JaxRnnOutputLayer(n_in=6, n_out=V, activation="softmax",
                           loss="mcxent")
    tl = RnnOutputLayer(n_in=6, n_out=V, activation="softmax", loss="mcxent")
    ref = np.asarray(jl.compute_loss_per_example(
        {"W": jnp.asarray(W), "b": jnp.asarray(b)}, jnp.asarray(x),
        jnp.asarray(y)))
    got = tl.compute_loss_per_example(
        {"W": torch.from_numpy(W), "b": torch.from_numpy(b)},
        torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    mask = None
    if masked:
        mask = np.ones((3, 5), np.float32)
        mask[1, 2:] = 0
        mask[2] = 0
    pre = x @ W + b
    jscore = float(jax_loss("mcxent").score(
        jnp.asarray(y), jnp.asarray(pre), jl.act(),
        None if mask is None else jnp.asarray(mask)))
    tscore = float(get_loss("mcxent").score(
        torch.from_numpy(y), torch.from_numpy(pre), tl.act(),
        None if mask is None else torch.from_numpy(mask)))
    assert tscore == pytest.approx(jscore, abs=1e-5)


def test_unported_loss_raises():
    """Every loss of the JAX registry is ported; a name neither package
    knows raises, listing the known ones."""
    from deeplearning4j_tpu.ops.losses import _REGISTRY as JAX_LOSSES
    from deeplearning4j_torch.ops.losses import _REGISTRY, get_loss

    assert set(_REGISTRY) == set(JAX_LOSSES)
    assert get_loss("MSE").name == "mse"
    with pytest.raises(ValueError, match="Unknown loss 'nosuch'.*mcxent"):
        get_loss("nosuch")


# --------------------------------------------------------- the small model
def _batch(seed, B=3):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, V, (B, KW["max_length"] + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[tok[:, :-1]], eye[tok[:, 1:]]


def _nets(updater=None, seed=5):
    """A JAX and a port TransformerLM on the same (JAX-drawn) weights;
    ``updater`` = (jax updater, port updater) replaces the conf's Adam."""
    jnet = JaxTransformerLM(seed=seed, **KW)
    jconf = jnet.conf()
    tnet = TransformerLM(seed=seed, max_cache=32, **KW)
    tconf = tnet.conf()
    if updater is not None:
        jconf.updater, tconf.updater = updater
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
    from deeplearning4j_torch.nn.graph import ComputationGraph

    j = JaxGraph(jconf).init()
    t = ComputationGraph(tconf).init(device="cpu")
    params_from_jax(jax.device_get(j.params), t)
    return j, t


def _jax_grads(jnet, x, y, lm=None):
    def loss(p):
        return jnet._loss(p, jnet.state, [jnp.asarray(x)], [jnp.asarray(y)],
                          None, None if lm is None else [jnp.asarray(lm)],
                          train=True, rng=None)[0]
    return jax.value_and_grad(loss)(jnet.params)


@pytest.mark.parametrize("helper", ["auto", "pallas"])
def test_loss_gradients_match_jax(helper):
    jnet, tnet = _nets()
    for name, v in jnet.conf.vertices.items():
        if name.startswith("attn"):
            v.layer.helper = helper
    x, y = _batch(1)
    jl, jg = _jax_grads(jnet, x, y)
    tl, tg = value_and_grad(tnet, tnet.params, tnet.state,
                            [torch.from_numpy(x)], [torch.from_numpy(y)])
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert set(tg) == set(jg)
    for v in jg:
        for k in jg[v]:
            ref = np.asarray(jg[v][k], np.float64)
            err = np.abs(tg[v][k].numpy() - ref).max()
            assert err <= 1e-4 * np.abs(ref).max(), f"{v}.{k}"


def test_label_mask_loss_matches_jax():
    jnet, tnet = _nets()
    x, y = _batch(2)
    lm = np.ones(y.shape[:2], np.float32)
    lm[0, 9:] = 0
    lm[2, :4] = 0
    jl, _ = _jax_grads(jnet, x, y, lm)
    ds = DataSet(x, y, labels_mask=lm)
    assert tnet.score(ds) == pytest.approx(float(jl), rel=1e-5)


def test_three_sgd_steps_match_jax_fit():
    jnet, tnet = _nets((jup.Sgd(learning_rate=0.1),
                        tup.Sgd(learning_rate=0.1)))
    x, y = _batch(3)
    jl, tl = [], []
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y), fused_steps=1, health_guard=None)
        jl.append(float(jnet.score_value))
        tnet.fit(DataSet(x, y))
        tl.append(tnet.score())
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert tnet.iteration == jnet.iteration == 3
    ref = jax.device_get(jnet.params)
    got = params_to_numpy(tnet)
    for v in ref:
        for k in ref[v]:
            np.testing.assert_allclose(got[v][k], ref[v][k], atol=1e-5,
                                       rtol=0, err_msg=f"{v}.{k}")
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(),
                               atol=1e-5, rtol=0)


def test_three_adam_steps_match_jax_losses():
    jnet, tnet = _nets()
    assert isinstance(tnet.conf.updater, tup.Adam)
    assert tnet.conf.updater.learning_rate == jnet.conf.updater.learning_rate
    x, y = _batch(4)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jnet.do_step([x], [y])[0]))
        loss, carry = tnet.do_step([x], [y])
        assert torch.is_tensor(loss) and loss.dim() == 0 and carry == {}
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_updater_state_round_trip_from_jax():
    jnet, tnet = _nets()
    x, y = _batch(5)
    for _ in range(2):
        jnet.do_step([x], [y])
    ref = jax.device_get(jnet.updater_state)
    updater_state_from_jax(ref, tnet, iteration=jnet.iteration)
    params_from_jax(jax.device_get(jnet.params), tnet)
    back = updater_state_to_numpy(tnet)
    assert set(back) == set(ref) == {"m", "v"}
    for s in ref:
        for v in ref[s]:
            for k in ref[s][v]:
                np.testing.assert_array_equal(back[s][v][k],
                                              np.asarray(ref[s][v][k]))
    # and the run continues where JAX stopped
    jl = float(jnet.do_step([x], [y])[0])
    tl = float(tnet.do_step([x], [y])[0])
    assert tnet.iteration == jnet.iteration == 3
    assert tl == pytest.approx(jl, rel=1e-4)
    bad = {s: dict(t) for s, t in ref.items()}
    bad["m"] = {v: dict(p) for v, p in ref["m"].items()}
    bad["m"]["embed"]["W"] = bad["m"]["embed"]["W"][:, :-1]
    with pytest.raises(ValueError, match="slot 'm'.*embed.W"):
        updater_state_from_jax(bad, tnet)


def test_params_flat_layout_matches_jax():
    jnet, tnet = _nets()
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())
    assert tnet.num_params() == jnet.num_params()
    flat = np.random.RandomState(6).randn(tnet.num_params()).astype(
        np.float32)
    tnet.set_params_flat(flat)
    np.testing.assert_array_equal(tnet.params_flat(), flat)
    with pytest.raises(ValueError, match="Flat param size"):
        tnet.set_params_flat(flat[:-1])


def test_fit_takes_an_iterable_and_counts_epochs():
    _, tnet = _nets((jup.Sgd(learning_rate=0.1), tup.Sgd(learning_rate=0.1)))
    batches = [DataSet(*_batch(7 + i)) for i in range(2)]
    tnet.fit(batches, epochs=2)
    assert tnet.iteration == 4 and tnet.epoch == 2
    x, y = _batch(9)
    tnet.fit(x, y)
    assert tnet.iteration == 5 and np.isfinite(tnet.score())


def test_zoo_conf_trains_with_adam_and_mcxent():
    conf = TransformerLM().conf()
    assert isinstance(conf.updater, tup.Adam)
    assert conf.updater.learning_rate == 3e-4
    out = conf.vertices["output"].layer
    assert out.loss == "mcxent" and out.activation == "softmax"
