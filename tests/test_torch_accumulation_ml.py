"""The port's threshold-encoded gradient accumulation
(``optimize/accumulation.py``), estimator wrappers (``ml.py``) and
``ProfilerListener`` (``optimize/listeners.py``) against the JAX
package's on the CPU:

- counterparts of ``tests/test_solvers.py::TestThresholdCompression``:
  messages and residuals bitwise JAX's ``threshold_encode`` (f32), the
  error feedback, the sparse wire round trip, the accumulator's mean
  equal to JAX's round by round;
- counterparts of the estimator part of ``tests/test_ml_and_guesser.py``
  (classifier, string labels, regressor, the parameter protocol), and the
  classifier on JAX's initial weights against JAX's estimator (rtol 1e-4
  over its Adam epochs), and against the net's own ``fit``/``output`` bit
  for bit;
- ``ProfilerListener``'s window (JAX's start/stop rule) and the Chrome
  trace it writes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.ml import DL4JClassifier, DL4JRegressor
from deeplearning4j_torch.optimize.accumulation import (
    BasicGradientsAccumulator, EncodingHandler, sparsify, threshold_encode,
    unsparsify)
from deeplearning4j_tpu.optimize import accumulation as jacc

pytestmark = pytest.mark.torch_port


# ------------------------------------------------------------ accumulation
class TestThresholdCompression:
    def test_encode_quantises_keeps_residual_and_equals_jax(self):
        g = np.asarray([0.5, -0.3, 0.001, -0.0005, 0.0, 0.01, -0.01],
                       np.float32)
        res = np.asarray([0.0, 0.0, 0.0095, 0.0, 0.0, 0.0, 0.0], np.float32)
        msg, new_res = threshold_encode(torch.from_numpy(g),
                                        torch.from_numpy(res), 0.01)
        jmsg, jres = jacc.threshold_encode(jnp.asarray(g), jnp.asarray(res),
                                           jnp.float32(0.01))
        np.testing.assert_array_equal(msg.numpy(), np.asarray(jmsg))
        np.testing.assert_array_equal(new_res.numpy(), np.asarray(jres))
        assert np.allclose(msg.numpy()[:3], [0.01, -0.01, 0.01])
        np.testing.assert_allclose(msg.numpy() + new_res.numpy(), g + res,
                                   atol=1e-7)

    def test_encode_equals_jax_on_random_gradients(self):
        rs = np.random.RandomState(0)
        g = (rs.randn(4096) * 0.02).astype(np.float32)
        res = (rs.randn(4096) * 0.005).astype(np.float32)
        msg, new_res = threshold_encode(torch.from_numpy(g),
                                        torch.from_numpy(res), 0.015)
        jmsg, jres = jacc.threshold_encode(jnp.asarray(g), jnp.asarray(res),
                                           jnp.float32(0.015))
        np.testing.assert_array_equal(msg.numpy(), np.asarray(jmsg))
        np.testing.assert_array_equal(new_res.numpy(), np.asarray(jres))

    def test_residual_error_feedback_transmits_eventually(self):
        h, jh = EncodingHandler(threshold=0.1), jacc.EncodingHandler(0.1)
        g = np.full(4, 0.03, np.float32)
        sent = np.zeros(4)
        for _ in range(10):
            m = h.encode(torch.from_numpy(g)).numpy()
            np.testing.assert_array_equal(m, np.asarray(jh.encode(g)))
            sent += m
        assert np.all(sent >= 0.2)
        np.testing.assert_allclose(sent + h._residual.numpy(), 0.3,
                                   atol=1e-6)
        assert h.residual_norm() == pytest.approx(jh.residual_norm(),
                                                  rel=1e-6)

    def test_sparse_wire_roundtrip(self):
        msg = np.array([0.01, 0.0, -0.01, 0.0, 0.01], np.float32)
        for m in (msg, torch.from_numpy(msg)):
            idx, signs = sparsify(m, 0.01)
            assert list(idx) == [0, 2, 4] and idx.dtype == np.int32
            np.testing.assert_array_equal(unsparsify(idx, signs, 0.01, 5),
                                          msg)
        jidx, jsigns = jacc.sparsify(msg, 0.01)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(signs, jsigns)

    @pytest.mark.parametrize("compress", [True, False])
    def test_accumulator_mean_equals_jax_and_converges(self, compress):
        rs = np.random.RandomState(7)
        W, D, theta, rounds = 4, 64, 0.05, 30
        grads = [np.clip(rs.randn(D) * 0.01, -0.04, 0.04).astype(np.float32)
                 for _ in range(W)]
        acc = BasicGradientsAccumulator(W, threshold=theta,
                                        compress=compress)
        jac = jacc.BasicGradientsAccumulator(W, threshold=theta,
                                             compress=compress)
        assert acc.get_update() is None
        total = np.zeros(D)
        for _ in range(rounds):
            for w in range(W):
                acc.store_update(w, torch.from_numpy(grads[w]))
                jac.store_update(w, grads[w])
            got = acc.get_update().numpy()
            np.testing.assert_array_equal(got, np.asarray(jac.get_update()))
            total += got
        true_total = np.mean(grads, axis=0) * rounds
        assert np.all(np.abs(total - true_total) <= 2 * theta + 1e-6)


# --------------------------------------------------------------- estimators
def _clf_conf(pkg="deeplearning4j_torch"):
    import importlib

    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    L = importlib.import_module(f"{pkg}.nn.conf.layers")
    i = importlib.import_module(f"{pkg}.nn.conf.inputs")
    u = importlib.import_module(f"{pkg}.nn.updater")
    return (b.NeuralNetConfiguration.builder()
            .seed(7).updater(u.Adam(learning_rate=0.05))
            .list(L.DenseLayer(n_out=16, activation="relu"),
                  L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(i.InputType.feed_forward(4)).build())


def _reg_conf():
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_torch.nn.updater import Adam

    return (NeuralNetConfiguration.builder()
            .seed(7).updater(Adam(learning_rate=0.05))
            .list(DenseLayer(n_out=16, activation="relu"),
                  OutputLayer(n_out=1, activation="identity", loss="mse"))
            .set_input_type(InputType.feed_forward(3)).build())


def _clf_data(seed=0, n=256):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 3, n)
    return (rs.randn(n, 4) + 2 * y[:, None]).astype(np.float32), y


class TestEstimators:
    def test_classifier_fit_predict_score(self):
        x, y = _clf_data()
        clf = DL4JClassifier(_clf_conf, epochs=30, batch_size=64,
                             device="cpu")
        assert clf.fit(x, y) is clf
        assert clf.score(x, y) > 0.9
        proba = clf.predict_proba(x[:5])
        assert proba.shape == (5, 3)
        np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)

    def test_classifier_string_labels(self):
        rs = np.random.RandomState(1)
        names = np.array(["cat", "dog", "fox"])
        yi = rs.randint(0, 3, 128)
        x = (rs.randn(128, 4) + 2 * yi[:, None]).astype(np.float32)
        clf = DL4JClassifier(_clf_conf, epochs=25, batch_size=64,
                             device="cpu")
        clf.fit(x, names[yi])
        assert set(clf.predict(x[:10])) <= set(names)
        assert clf.score(x, names[yi]) > 0.8

    def test_regressor_r2(self):
        rs = np.random.RandomState(2)
        x = rs.randn(256, 3).astype(np.float32)
        y = (x @ np.array([1.0, -2.0, 0.5])).astype(np.float32)
        reg = DL4JRegressor(_reg_conf, epochs=60, batch_size=64,
                            device="cpu")
        reg.fit(x, y)
        assert reg.score(x, y) > 0.8
        assert reg.predict(x[:7]).shape == (7,)

    def test_params_protocol_and_unfitted(self):
        clf = DL4JClassifier(_clf_conf, epochs=3)
        p = clf.get_params()
        assert p["epochs"] == 3 and p["device"] is None
        clf.set_params(epochs=5, device="cpu")
        assert clf.epochs == 5 and clf.device == "cpu"
        with pytest.raises(ValueError):
            clf.set_params(nope=1)
        with pytest.raises(RuntimeError):
            clf.predict(np.zeros((1, 4)))

    def test_classifier_equals_the_nets_own_fit(self):
        """The estimator trains exactly the net its factory builds: the
        same parameters and probabilities, bit for bit, as ``fit`` over a
        ``ListDataSetIterator`` and ``output``."""
        from deeplearning4j_torch.datasets.dataset import DataSet
        from deeplearning4j_torch.datasets.iterators import (
            ListDataSetIterator)
        from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

        x, y = _clf_data(3, 96)
        clf = DL4JClassifier(_clf_conf, epochs=4, batch_size=32,
                             device="cpu").fit(x, y)
        net = MultiLayerNetwork(_clf_conf()).init(device="cpu")
        net.fit(ListDataSetIterator(DataSet(x, np.eye(3, dtype=np.float32)
                                            [y]), batch_size=32), epochs=4)
        np.testing.assert_array_equal(clf.net_.params_flat(),
                                      net.params_flat())
        np.testing.assert_array_equal(clf.predict_proba(x),
                                      net.output(x).numpy())

    def test_classifier_on_jax_weights_matches_jax_estimator(self,
                                                            monkeypatch):
        """Started from JAX's initial weights (the initializers' draws
        differ), the port's classifier ends on JAX's estimator's
        probabilities within 1e-4 after four Adam epochs."""
        from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_torch.utils.convert import params_from_jax
        from deeplearning4j_tpu.ml import DL4JClassifier as JClassifier
        from deeplearning4j_tpu.nn.multilayer import (
            MultiLayerNetwork as JNet)

        init = MultiLayerNetwork.init
        jparams = jax.device_get(
            JNet(_clf_conf("deeplearning4j_tpu")).init().params)

        def jax_init(self, params=None, *, device=None):
            init(self, device=device)
            return params_from_jax(jparams, self)

        monkeypatch.setattr(MultiLayerNetwork, "init", jax_init)
        x, y = _clf_data(5, 128)
        clf = DL4JClassifier(_clf_conf, epochs=4, batch_size=64,
                             device="cpu").fit(x, y)
        jclf = JClassifier(lambda: _clf_conf("deeplearning4j_tpu"),
                           epochs=4, batch_size=64).fit(x, y)
        np.testing.assert_allclose(clf.predict_proba(x),
                                   jclf.predict_proba(x), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(clf.classes_, jclf.classes_)


# ---------------------------------------------------------------- profiler
def test_profiler_listener_window_and_trace(tmp_path):
    """The trace starts at the first iteration in ``[start, start + n)``
    and stops at the first past it, as JAX's listener does; the Chrome
    trace written to ``log_dir`` holds the window's CPU events."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.optimize.listeners import ProfilerListener

    lst = ProfilerListener(str(tmp_path), start_iteration=2,
                           num_iterations=3)
    net = MultiLayerNetwork(_clf_conf()).init(device="cpu")
    net.set_listeners(lst)
    x, y = _clf_data(1, 64)
    batches = [DataSet(x[i:i + 8], np.eye(3, dtype=np.float32)[y[i:i + 8]])
               for i in range(0, 64, 8)]
    seen = []
    for it in range(1, 5):
        lst.iteration_done(net, it)
        seen.append(lst._active)
    assert seen == [False, True, True, True]
    lst.iteration_done(net, 5)
    assert not lst._active and lst.trace_path.endswith("trace_2_5.json")
    lst.trace_path = None
    net.fit(batches, fused_steps=1)           # the window in a real fit
    assert net.iteration == 8 and not lst._active
    with open(lst.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
