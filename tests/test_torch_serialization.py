"""Port parity of the model zip, the contract between the two packages
(``deeplearning4j_torch/utils/{serde,pytree,model_serializer}.py`` against
the JAX package's modules of the same names):

- gate 1: the port loads the committed JAX-saved
  ``tests/fixtures/regression_transformer_r5.zip`` and reproduces
  ``regression_transformer_r5_expected.npz`` (``params_sum`` within 1e-4,
  the probe's output within 1e-5, as ``tests/test_format_regression.py``
  holds the JAX package), and the loaded net streams and trains;
- gate 2: JAX -> zip -> port -> zip keeps ``coefficients.bin`` byte for
  byte, and the JAX package loads the port's zip to the same ``output()``;
- the updater state (Adam's ``m``, ``v`` and the iteration) round-trips:
  one Adam step after loading equals the JAX package's within 1e-6;
- the configuration JSON: every class the port registers carries the JAX
  class's fields in order, the port's JSON reads back in the JAX package
  to the same JSON, and an unknown ``@class`` (or field) raises naming it.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402

from deeplearning4j_tpu.models.zoo import (  # noqa: E402
    TransformerLM as JaxTransformerLM)
from deeplearning4j_tpu.utils import model_serializer as jms  # noqa: E402
from deeplearning4j_tpu.utils import serde as jserde  # noqa: E402
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.nn.conf.graph_conf import (  # noqa: E402
    ComputationGraphConfiguration)
from deeplearning4j_torch.utils import model_serializer as ms  # noqa: E402
from deeplearning4j_torch.utils import serde  # noqa: E402
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
ZIP = os.path.join(FIXTURES, "regression_transformer_r5.zip")
EXPECTED = os.path.join(FIXTURES, "regression_transformer_r5_expected.npz")
#: the classes regression_transformer_r5.zip names, and the port's updaters
CLASSES = ["ComputationGraphConfiguration", "LayerVertex",
           "ElementWiseVertex", "DenseLayer", "PositionalEncodingLayer",
           "LayerNormalization", "SelfAttentionLayer", "RnnOutputLayer",
           "Adam", "LearningRateSchedule", "InputType", "Sgd", "Nesterovs",
           "AdaMax", "Nadam", "AdaGrad", "RmsProp", "AdaDelta", "NoOp"]


def _entry(path, name):
    with zipfile.ZipFile(path) as zf:
        return zf.read(name)


def test_fixture_loads_and_reproduces():
    """Gate 1, on the CPU, as tests/test_format_regression.py holds JAX."""
    net = ms.load_model(ZIP, device="cpu")
    exp = np.load(EXPECTED)
    assert abs(float(net.params_flat().sum())
               - float(exp["params_sum"])) < 1e-4
    out = net.output(exp["probe"]).numpy()
    np.testing.assert_allclose(out, exp["output"], atol=1e-5)
    assert (net.iteration, net.epoch) == (3, 0)
    assert set(net.updater_state) == {"m", "v"}


def test_loaded_net_streams_and_trains():
    net = ms.load_model(ZIP, device="cpu")
    exp = np.load(EXPECTED)
    probe = exp["probe"]
    V = probe.shape[-1]
    net.rnn_clear_previous_state()
    first = net.rnn_time_step(probe[:, :2])
    step = net.rnn_time_step(probe[:, 2])           # one 2-D step
    assert first.shape == (2, 2, V) and step.shape == (2, V)
    full = net.output(probe[:, :3])
    np.testing.assert_allclose(step.numpy(), full[:, 2].numpy(), atol=1e-6)
    np.testing.assert_allclose(first.numpy(), full[:, :2].numpy(),
                               atol=1e-6)
    rs = np.random.RandomState(1)
    oh = np.eye(V, dtype=np.float32)[rs.randint(0, V, (2, probe.shape[1]))]
    before = net.params_flat().copy()
    net.fit(DataSet(oh, oh))
    assert net.iteration == 4
    assert np.abs(net.params_flat() - before).max() > 0
    net.rnn_clear_previous_state()
    assert net.rnn_time_step(probe[:, :3]).shape == (2, 3, V)


def test_stream_overflow_raises():
    net = ms.load_model(ZIP, device="cpu")
    layer = net.conf.vertices["attn0"].layer
    layer.max_cache = 4
    x = np.load(EXPECTED)["probe"]
    net.rnn_clear_previous_state()
    net.rnn_time_step(x[:, :3])
    with pytest.raises(ValueError, match="KV cache overflow"):
        net.rnn_time_step(x[:, 3:5])


def test_zip_round_trip_jax_port_jax(tmp_path):
    """Gate 2: a JAX-saved zip of a freshly drawn JAX net, loaded and saved
    by the port, keeps its coefficients byte for byte; the JAX package
    loads the port's zip and computes the same output."""
    jnet = JaxTransformerLM(num_labels=11, max_length=8, d_model=32,
                            n_heads=4, n_blocks=2, seed=5).init()
    a, b = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jms.save_model(jnet, a)
    net = ms.load_model(a, device="cpu")
    ms.save_model(net, b)
    assert _entry(a, "coefficients.bin") == _entry(b, "coefficients.bin")
    back = jms.load_model(b)
    x = np.eye(11, dtype=np.float32)[np.random.RandomState(2).randint(
        0, 11, (2, 8))]
    np.testing.assert_array_equal(np.asarray(back.output(x)),
                                  np.asarray(jnet.output(x)))
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5)
    assert back.iteration == jnet.iteration
    for slot in ("m", "v"):
        for v, p in jnet.updater_state[slot].items():
            for k, t in p.items():
                np.testing.assert_array_equal(
                    np.asarray(back.updater_state[slot][v][k]),
                    np.asarray(t))


def test_port_zip_loads_in_jax(tmp_path):
    """A zip the port writes of its own net (the port's JSON, its flat
    order) loads in the JAX package with the same parameters and an
    output within 1e-5."""
    net = TransformerLM(num_labels=11, max_length=8, d_model=32, n_heads=4,
                        n_blocks=1).init(device="cpu")
    net.iteration, net.epoch = 7, 2
    path = str(tmp_path / "port.zip")
    ms.save_model(net, path)
    jnet = jms.load_model(path)
    np.testing.assert_array_equal(np.asarray(jnet.params_flat()),
                                  net.params_flat())
    assert (jnet.iteration, jnet.epoch) == (7, 2)
    x = np.eye(11, dtype=np.float32)[np.arange(8)[None] % 11]
    np.testing.assert_allclose(np.asarray(jnet.output(x)),
                               net.output(x).numpy(), atol=1e-5)


def test_updater_state_round_trips_one_adam_step():
    """Adam's m, v and the iteration come back from the zip: one step after
    loading moves the parameters as the JAX package's step does."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet

    jnet = jms.load_model(ZIP)
    net = ms.load_model(ZIP, device="cpu")
    V = 7
    rs = np.random.RandomState(4)
    tok = rs.randint(0, V, (3, 9))
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[tok[:, :-1]], eye[tok[:, 1:]]
    jnet.fit(JaxDataSet(x, y), fused_steps=1, health_guard=None)
    net.fit(DataSet(x, y))
    assert net.iteration == jnet.iteration == 4
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()), atol=1e-6)
    for slot in ("m", "v"):
        for v, p in jnet.updater_state[slot].items():
            for k, t in p.items():
                np.testing.assert_allclose(
                    net.updater_state[slot][v][k].numpy(), np.asarray(t),
                    atol=1e-6, err_msg=f"{slot}/{v}/{k}")


@pytest.mark.parametrize("name", CLASSES)
def test_port_class_carries_the_jax_fields(name):
    serde._ensure_registry()
    ours = serde._CLASSES[name]
    jserde._ensure_registry()
    theirs = jserde._CLASSES[name]
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]


def test_port_json_reads_back_in_jax():
    """The port's configuration JSON, read by the JAX package's serde and
    written again, is the same JSON."""
    conf = TransformerLM(num_labels=11, max_length=8, d_model=32, n_heads=4,
                         n_blocks=2).conf()
    text = conf.to_json()
    jconf = jserde.from_json(text)
    assert type(jconf).__name__ == "ComputationGraphConfiguration"
    assert json.loads(jserde.to_json(jconf)) == json.loads(text)
    again = ComputationGraphConfiguration.from_json(text)
    assert again.to_json() == text


def test_fixture_json_reads_back_as_jax_reads_it():
    """The fixture's JSON (written before ``remat`` and ``paged_attention``
    existed) read and written again: the same JSON as the JAX package's
    own read and write, missing fields at their defaults."""
    raw = _entry(ZIP, "configuration.json").decode()
    conf = ComputationGraphConfiguration.from_json(raw)
    assert json.loads(conf.to_json()) == json.loads(
        jserde.to_json(jserde.from_json(raw)))


@pytest.mark.parametrize("where", ["top", "layer", "field"])
def test_unknown_class_or_field_raises_naming_it(where):
    d = json.loads(_entry(ZIP, "configuration.json"))
    if where == "top":
        d["@class"], match = "BogusConfiguration", "BogusConfiguration"
    elif where == "layer":
        d["vertices"]["attn0"]["layer"]["@class"] = "BogusAttention"
        match = "BogusAttention"
    else:
        d["vertices"]["ff0a"]["layer"]["bogus_knob"] = 3
        match = "bogus_knob"
    with pytest.raises(ValueError, match=match):
        serde.from_json(json.dumps(d))


def test_multilayer_zip_raises_naming_a7():
    with pytest.raises(NotImplementedError, match="A7"):
        ms.load_model(os.path.join(FIXTURES, "regression_convnet_r4.zip"),
                      device="cpu")


def test_load_model_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ms.load_model(ZIP)


def test_unported_fields_are_refused_where_they_act(tmp_path):
    """Set away from their defaults in a zip's JSON, the fields the port
    cannot honour yet raise where they would act: dropout and per-layer
    learning rates in training, ``compute_dtype`` in every forward,
    another weight init when drawing weights."""
    d = json.loads(_entry(ZIP, "configuration.json"))
    d["vertices"]["ff0a"]["layer"]["dropout"] = 0.1
    net = ms.net_from_conf(serde.from_json(json.dumps(d)), device="cpu")
    x = np.load(EXPECTED)["probe"]
    net.output(x)                                    # inference is fine
    with pytest.raises(NotImplementedError, match="dropout"):
        net.do_step(x, x)
    d = json.loads(_entry(ZIP, "configuration.json"))
    d["compute_dtype"] = "bfloat16"
    net = ms.net_from_conf(serde.from_json(json.dumps(d)), device="cpu")
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        net.output(x)
    d = json.loads(_entry(ZIP, "configuration.json"))
    d["vertices"]["embed"]["layer"]["weight_init"] = "relu"
    with pytest.raises(NotImplementedError, match="weight_init"):
        ms.net_from_conf(serde.from_json(json.dumps(d)), device="cpu")
    # a zip's weights are loaded, not drawn: its init scheme never acts
    path = str(tmp_path / "relu.zip")
    with zipfile.ZipFile(ZIP) as src, zipfile.ZipFile(path, "w") as dst:
        for name in src.namelist():
            dst.writestr(name, json.dumps(d) if name == "configuration.json"
                         else src.read(name))
    np.testing.assert_allclose(ms.load_model(path, device="cpu").output(x),
                               np.load(EXPECTED)["output"], atol=1e-5)


def test_params_from_a_zip_equal_params_from_jax():
    """The zip path and the in-memory path (``params_from_jax``) give the
    same parameters."""
    jnet = jms.load_model(ZIP)
    net = ms.load_model(ZIP, device="cpu")
    other = ms.load_model(ZIP, device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), other)
    for v, p in net.params.items():
        for k, t in p.items():
            assert torch.equal(t, other.params[v][k]), (v, k)


def test_state_npz_keys_match_jax(tmp_path):
    """``updaterState.bin`` uses the JAX package's ``slot/vertex/name``
    keys, and the port's zip holds the same entries."""
    path = str(tmp_path / "port.zip")
    ms.save_model(ms.load_model(ZIP, device="cpu"), path)
    names = {n: set(np.load(io.BytesIO(_entry(p, "updaterState.bin"))).files)
             for n, p in (("jax", ZIP), ("port", path))}
    assert names["jax"] == names["port"]
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == sorted(zipfile.ZipFile(
            ZIP).namelist())
