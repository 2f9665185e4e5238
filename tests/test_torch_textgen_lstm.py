"""``zoo.TextGenerationLSTM`` in the port against the JAX package's, on the
CPU, at ``num_labels=11, max_length=8`` (the zoo's full width: two
GravesLSTM(256) layers), from a JAX model zip of a net the JAX package
trained a few TBPTT steps on a periodic character stream (so its next-token
choices are clear of ties):

- ``output()`` within 1e-5 of JAX's;
- ``rnn_time_step`` in chunks of 1 and of 3 equal to ``output()``, and
  ``output()`` unchanged by a live stream (h/c stay in the streaming carry);
- greedy tokens equal to JAX's on the device loop and the host loop;
  sampled tokens equal to JAX's on the device loop (the bitwise
  ``jax.random`` keys) and on the host loop (numpy's ``RandomState``);
- the zip both ways: the JAX zip's configuration, coefficients and RmsProp
  state load in the port, which trains on from them (the segment losses
  within rtol 1e-5 and the first-step gradients within 1e-5 of the net's
  max|g| of JAX's; the parameters after the step within 1e-4 of max|p|:
  RmsProp's step ``lr·g/sqrt(h)`` turns an f32 rounding of g into up to
  ``lr/sqrt(h)`` times as much in the parameters); a port-saved zip loads
  in JAX with the same ``coefficients.bin`` and updater state;
- the ``textgenlstm`` zoo key and the configuration JSON, JAX's field for
  field.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.models import zoo as tz
from deeplearning4j_torch.optimize.fused_fit import value_and_grad
from deeplearning4j_torch.utils import model_serializer as tms
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jz
from deeplearning4j_tpu.utils import model_serializer as jms

pytestmark = pytest.mark.torch_port

V = 11
KW = dict(num_labels=V, max_length=8)
EYE = np.eye(V, dtype=np.float32)


def _periodic(n, T, seed):
    """Rows of a period-5 character cycle from random offsets, and their
    next characters."""
    rs = np.random.RandomState(seed)
    cycle = np.array([1, 4, 7, 2, 9])
    start = rs.randint(0, 5, n)
    idx = cycle[(start[:, None] + np.arange(T + 1)) % 5]
    return EYE[idx[:, :-1]], EYE[idx[:, 1:]]


@pytest.fixture(scope="module")
def jax_zip(tmp_path_factory):
    net = jz.TextGenerationLSTM(**KW).init()
    for s in range(6):
        net.fit(JDataSet(*_periodic(4, 50, s)))
    path = str(tmp_path_factory.mktemp("textgen") / "jax_textgen.zip")
    jms.save_model(net, path)
    return path


@pytest.fixture
def pair(jax_zip):
    return jms.load_model(jax_zip), tms.load_model(jax_zip, device="cpu")


def _prompt():
    x, _ = _periodic(3, 8, seed=40)
    return x


def test_output_of_the_jax_zip_matches_jax(pair):
    jnet, tnet = pair
    x = _prompt()
    assert tnet.device.type == "cpu"
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk", [1, 3])
def test_rnn_time_step_chunks_equal_output(pair, jax_zip, chunk):
    _, tnet = pair
    x = _prompt()
    full = tnet.output(x).numpy()
    tnet.rnn_clear_previous_state()
    parts = []
    for s in range(0, x.shape[1], chunk):
        step = x[:, s] if chunk == 1 else x[:, s:s + chunk]
        out = tnet.rnn_time_step(step).numpy()
        parts.append(out[:, None] if chunk == 1 else out)
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)
    # the stream is live: h/c sit in the streaming carry, not the state
    assert set(tnet._rnn_state) == {"0", "1"}
    assert all(set(c) == {"h", "c"} for c in tnet._rnn_state.values())
    assert all(not st for st in tnet.state.values())
    np.testing.assert_array_equal(tnet.output(x).numpy(), full)
    fresh = tms.load_model(jax_zip, device="cpu")
    np.testing.assert_array_equal(tnet.output(x).numpy(),
                                  fresh.output(x).numpy())
    # the stream goes on from where it stopped
    x2 = _periodic(3, 4, seed=41)[0]
    nxt = tnet.rnn_time_step(x2).numpy()
    whole = tnet.output(np.concatenate([x, x2], axis=1)).numpy()
    np.testing.assert_allclose(nxt, whole[:, x.shape[1]:], atol=1e-6, rtol=0)


@pytest.mark.parametrize("loop", ["device", "host"])
def test_greedy_tokens_equal_jax(pair, loop):
    jnet, tnet = pair
    prompt = np.argmax(_prompt(), -1)[:, :5]
    want = jz.greedy_generate(jnet, prompt, 12, V,
                              device_loop=loop == "device")
    got = tz.greedy_generate(tnet, prompt, 12, V,
                             device_loop=loop == "device")
    np.testing.assert_array_equal(got, want)
    # the net learnt the cycle: greedy continues it
    cycle = [1, 4, 7, 2, 9]
    nxt = cycle[(cycle.index(prompt[0, -1]) + 1) % 5]
    assert got[0, 0] == nxt
    assert tnet._rnn_state is None or loop == "host"


@pytest.mark.parametrize("loop", ["device", "host"])
def test_sampled_tokens_equal_jax(pair, loop):
    jnet, tnet = pair
    prompt = np.argmax(_prompt(), -1)[:, :5]
    kw = dict(temperature=1.5, top_k=6, seed=7, device_loop=loop == "device")
    want = jz.sample_generate(jnet, prompt, 16, V, **kw)
    got = tz.sample_generate(tnet, prompt, 16, V, **kw)
    np.testing.assert_array_equal(got, want)
    greedy = tz.greedy_generate(tnet, prompt, 16, V)
    assert not np.array_equal(got, greedy)


def test_jax_zip_trains_on_in_the_port(pair):
    """The RmsProp state came with the zip; one more TBPTT batch (two
    segments) trains as JAX's does."""
    jnet, tnet = pair
    for k in jnet.updater_state["h"]:
        for n, h in jnet.updater_state["h"][k].items():
            np.testing.assert_array_equal(
                tnet.updater_state["h"][k][n].numpy(), np.asarray(h))
    assert tnet.iteration == jnet.iteration == 6
    x, y = _periodic(4, 100, seed=50)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jnet._loss(p, jnet.state, jnp.asarray(x[:, :50]),
                             jnp.asarray(y[:, :50]), None, None, train=True,
                             rng=None, carry={}), has_aux=True)(jnet.params)
    tl, tg = value_and_grad(tnet, tnet.params, tnet.state,
                            torch.from_numpy(x[:, :50]),
                            torch.from_numpy(y[:, :50]), train=True)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    top = max(float(np.abs(np.asarray(g)).max()) for p in jg.values()
              for g in p.values())
    for v in jg:
        for k, g in jg[v].items():
            np.testing.assert_allclose(tg[v][k].numpy(), np.asarray(g),
                                       rtol=0, atol=1e-5 * top,
                                       err_msg=f"{v}.{k}")
    losses = {"jax": [], "port": []}

    class Rec:
        def __init__(self, key):
            self.key = key

        def iteration_done(self, model, iteration):
            losses[self.key].append(float(model.score_value))

    jnet.set_listeners(Rec("jax"))
    tnet.set_listeners(Rec("port"))
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert len(losses["port"]) == 2
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    want = np.asarray(jnet.params_flat())
    np.testing.assert_allclose(tnet.params_flat(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_port_zip_loads_in_jax(pair, tmp_path):
    _, tnet = pair
    tnet.fit(DataSet(*_periodic(2, 50, seed=60)))
    path = str(tmp_path / "port_textgen.zip")
    tms.save_model(tnet, path)
    with zipfile.ZipFile(path) as zf:
        coeff = zf.read("coefficients.bin")
    assert coeff == tnet.params_flat().astype("<f4").tobytes()
    back = jms.load_model(path)
    assert type(back).__name__ == "MultiLayerNetwork"
    assert np.asarray(back.params_flat()).astype("<f4").tobytes() == coeff
    assert back.conf.backprop_type == "tbptt"
    assert back.conf.tbptt_fwd_length == 50
    for k in back.updater_state["h"]:
        for n, h in back.updater_state["h"][k].items():
            np.testing.assert_array_equal(
                np.asarray(h), tnet.updater_state["h"][k][n].numpy())
    x = _prompt()
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               tnet.output(x).numpy(), atol=1e-5, rtol=0)


def test_zoo_key_and_configuration_match_jax():
    assert tz.zoo_models()["textgenlstm"] is tz.TextGenerationLSTM
    jconf = json.loads(jz.TextGenerationLSTM(**KW).conf().to_json())
    tconf = json.loads(tz.TextGenerationLSTM(**KW).conf().to_json())
    assert tconf == jconf
    net = tz.TextGenerationLSTM().init(device="cpu")
    assert net.num_params() == sum(
        np.asarray(v).size for p in jz.TextGenerationLSTM().init().params
        .values() for v in p.values())
    assert [type(la).__name__ for la in net.layers] == [
        "GravesLSTM", "GravesLSTM", "RnnOutputLayer"]
