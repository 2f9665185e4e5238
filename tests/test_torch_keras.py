"""Port parity: Keras import (``deeplearning4j_torch/modelimport/keras.py``)
and the model guesser (``utils/model_guesser.py``) against the JAX
package's, on the CPU — the cases of ``tests/test_modelimport.py`` (Keras 3
files written by the installed Keras, Keras-1-style files written with
h5py), the Keras case of ``tests/test_quantize.py``, the guesser and
server cases of ``tests/test_ml_and_guesser.py`` and the guesser case of
``tests/test_format_regression.py``.

Every imported net is held to Keras's own ``predict`` (``atol 1e-4, rtol
1e-3``, the JAX tests' bound) and to the JAX package's import of the same
file (``JAX_ATOL``: the same weights through the same layers, float
summation order apart). The importers also read ``chip_smoke.py``'s
``InMemoryH5`` source (what phase 14e runs where h5py is absent) to the
same net.

Keras (TensorFlow backend) costs ~20 s to import, so every case that needs
it lives in this one module.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu import modelimport as jimport  # noqa: E402
from deeplearning4j_tpu.utils import model_guesser as jguess  # noqa: E402
from deeplearning4j_torch import modelimport as timport  # noqa: E402
from deeplearning4j_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.utils import model_guesser as tguess  # noqa: E402
from chip_smoke import InMemoryH5  # noqa: E402
from tests.test_modelimport import TestKeras1StyleImport as _K1  # noqa: E402,E501

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
JAX_ATOL = 1e-5


@pytest.fixture(scope="module")
def keras():
    return pytest.importorskip("keras")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _outs(net, *xs):
    out = net.output(*xs)
    return [_np(o) for o in out] if isinstance(out, (list, tuple)) \
        else [_np(out)]


def _check(path, xs, expected=None, sequential=False, kind=None):
    """Import ``path`` with both packages and from an in-memory copy; all
    three agree, and with Keras's ``expected`` outputs."""
    port_fn = (timport.import_keras_sequential_model_and_weights
               if sequential else timport.import_keras_model_and_weights)
    jax_fn = (jimport.import_keras_sequential_model_and_weights
              if sequential else jimport.import_keras_model_and_weights)
    net = port_fn(path, device=CPU)
    if kind is not None:
        assert isinstance(net, kind)
    got = _outs(net, *xs)
    for g, w in zip(got, _outs(jax_fn(path), *xs)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=JAX_ATOL)
    with h5py.File(path, "r") as f:
        mem = InMemoryH5.read(f)
    for g, w in zip(got, _outs(port_fn(mem, device=CPU), *xs)):
        np.testing.assert_array_equal(g, w)
    if expected is not None:
        expected = expected if isinstance(expected, list) else [expected]
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            np.testing.assert_allclose(g, np.asarray(e), atol=1e-4,
                                       rtol=1e-3)
    return net


def _saved(m, tmp_path, name):
    path = str(tmp_path / name)
    m.save(path)
    return path


class TestKeras3Import:
    def test_cnn_sequential(self, keras, tmp_path):
        from keras import layers

        m = keras.Sequential([
            keras.Input((8, 8, 2)),
            layers.Conv2D(4, (3, 3), padding="same", activation="relu"),
            layers.MaxPooling2D((2, 2)),
            layers.Conv2D(6, (3, 3), padding="valid", activation="tanh"),
            layers.Flatten(),
            layers.Dense(5, activation="softmax")])
        x = np.random.RandomState(0).randn(3, 8, 8, 2).astype(np.float32)
        net = _check(_saved(m, tmp_path, "cnn.h5"), [x],
                     m.predict(x, verbose=0), sequential=True)
        assert len(net.conf.layers) == 4  # flatten absorbed

    def test_mlp_with_bn_dropout(self, keras, tmp_path):
        from keras import layers

        m = keras.Sequential([
            keras.Input((6,)), layers.Dense(10, activation="relu"),
            layers.BatchNormalization(), layers.Dropout(0.5),
            layers.Dense(3, activation="softmax")])
        m.compile(loss="categorical_crossentropy", optimizer="sgd")
        rs = np.random.RandomState(1)
        m.fit(rs.randn(64, 6) * 3 + 1, np.eye(3)[rs.randint(0, 3, 64)],
              epochs=1, verbose=0)
        x = rs.randn(4, 6).astype(np.float32)
        net = _check(_saved(m, tmp_path, "mlp.h5"), [x],
                     m.predict(x, verbose=0), sequential=True)
        bn = net.state["1"]
        moving = m.layers[1].get_weights()
        np.testing.assert_array_equal(_np(bn["mean"]), moving[2])
        np.testing.assert_array_equal(_np(bn["var"]), moving[3])

    def test_lstm(self, keras, tmp_path):
        from keras import layers

        m = keras.Sequential([
            keras.Input((7, 5)),
            layers.LSTM(6, activation="tanh",
                        recurrent_activation="sigmoid",
                        return_sequences=True),
            layers.Dense(3, activation="softmax")])
        x = np.random.RandomState(2).randn(2, 7, 5).astype(np.float32)
        _check(_saved(m, tmp_path, "lstm.h5"), [x],
               m.predict(x, verbose=0), sequential=True)

    def test_global_pooling(self, keras, tmp_path):
        from keras import layers

        m = keras.Sequential([
            keras.Input((6, 6, 3)),
            layers.Conv2D(8, (3, 3), padding="same", activation="relu"),
            layers.GlobalAveragePooling2D(),
            layers.Dense(4, activation="softmax")])
        x = np.random.RandomState(3).randn(2, 6, 6, 3).astype(np.float32)
        _check(_saved(m, tmp_path, "gap.h5"), [x], m.predict(x, verbose=0),
               sequential=True)

    def test_quantize_knob(self, keras, tmp_path):
        """``quantize="int8"``: the JAX package's eval-parity rule against
        the f32 import (confusion delta <= 0.05), and the int8 outputs
        within 1e-5 of JAX's int8 import."""
        from keras import layers

        from deeplearning4j_torch.datasets.dataset import DataSet
        from deeplearning4j_torch.optimize.quantize import confusion_delta

        m = keras.Sequential([keras.Input((6,)),
                              layers.Dense(12, activation="relu"),
                              layers.Dense(3, activation="softmax")])
        path = _saved(m, tmp_path, "mlp.h5")
        imp = timport.import_keras_sequential_model_and_weights
        net = imp(path, device=CPU)
        qnet = imp(path, quantize="int8", device=CPU)
        rs = np.random.RandomState(3)
        x = rs.randn(48, 6).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 48)]
        assert confusion_delta(net.evaluate(DataSet(x, y)),
                               qnet.evaluate(DataSet(x, y))) <= 0.05
        jq = jimport.import_keras_sequential_model_and_weights(
            path, quantize="int8")
        np.testing.assert_allclose(_np(qnet.output(x)),
                                   np.asarray(jq.output(x)), atol=JAX_ATOL)
        assert qnet.params["0"]["W"].dtype == torch.int8


class TestKeras1StyleImport:
    def test_th_model_matches_manual_forward(self, tmp_path):
        """A hand-written Keras-1 file (th ordering, true convolution):
        the port's import against the JAX import and a numpy forward."""
        from scipy.signal import convolve2d

        path = str(tmp_path / "k1.h5")
        kernel_th, conv_b, dense_W, dense_b, (cin, h, w) = \
            _K1()._write_k1_fixture(path)
        rs = np.random.RandomState(5)
        x_th = rs.randn(2, cin, h, w).astype(np.float32)
        B, cout = x_th.shape[0], kernel_th.shape[0]
        conv = np.zeros((B, cout, h, w), np.float32)
        for b in range(B):
            for o in range(cout):
                acc = np.zeros((h, w))
                for ci in range(cin):
                    acc += convolve2d(x_th[b, ci], kernel_th[o, ci],
                                      mode="same")
                conv[b, o] = acc + conv_b[o]
        pooled = np.maximum(conv, 0).reshape(B, cout, 3, 2, 3, 2).max(
            axis=(3, 5))
        logits = pooled.reshape(B, -1) @ dense_W + dense_b
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        _check(path, [np.transpose(x_th, (0, 2, 3, 1))],
               e / e.sum(axis=1, keepdims=True), sequential=True,
               kind=MultiLayerNetwork)

    def test_unsupported_layer_raises(self, tmp_path):
        path = str(tmp_path / "bad.h5")
        config = {"class_name": "Sequential", "config": [
            {"class_name": "Lambda", "config": {
                "name": "l", "batch_input_shape": [None, 4]}}]}
        with h5py.File(path, "w") as f:
            f.attrs["model_config"] = json.dumps(config)
        with pytest.raises(ValueError, match="Unsupported Keras layer"):
            timport.import_keras_sequential_model_and_weights(path,
                                                              device=CPU)
        with pytest.raises(ValueError, match="model_config"):
            with h5py.File(path, "w"):
                pass
            timport.import_keras_model_and_weights(path, device=CPU)


def _legacy(path, layers, inputs, outputs, weights):
    config = {"class_name": "Model", "config": {
        "name": "m", "layers": layers, "input_layers": inputs,
        "output_layers": outputs}}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(config)
        mw = f.create_group("model_weights")
        for name, arrays in weights.items():
            g = mw.create_group(name)
            g.attrs["weight_names"] = [n.encode() for n, _ in arrays]
            for n, a in arrays:
                g.create_dataset(n, data=a)


def _softmax(z):
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


class TestFunctionalImport:
    def test_residual_add_concat(self, keras, tmp_path):
        from keras import layers

        inp = keras.Input((8, 8, 3), name="in0")
        x = layers.Conv2D(4, (3, 3), padding="same", activation="relu",
                          name="c1")(inp)
        y = layers.Conv2D(4, (3, 3), padding="same", name="c2")(x)
        z = layers.Activation("relu", name="act1")(
            layers.Add(name="add1")([x, y]))
        w = layers.Conv2D(2, (1, 1), padding="same", name="c3")(z)
        cat = layers.Concatenate(name="cat1")([z, w])
        out = layers.Dense(5, activation="softmax", name="d1")(
            layers.Flatten(name="fl")(cat))
        m = keras.Model(inp, out)
        x = np.random.RandomState(0).randn(3, 8, 8, 3).astype(np.float32)
        _check(_saved(m, tmp_path, "residual.h5"), [x],
               m.predict(x, verbose=0), kind=ComputationGraph)

    def test_branched_bn_pool(self, keras, tmp_path):
        from keras import layers

        inp = keras.Input((8, 8, 2), name="in0")
        a = layers.BatchNormalization(name="bn_a")(
            layers.Conv2D(3, (3, 3), padding="same", name="ca")(inp))
        b = layers.Conv2D(3, (1, 1), padding="same", name="cb")(
            layers.AveragePooling2D((1, 1), name="pb")(inp))
        s = layers.GlobalAveragePooling2D(name="gap")(
            layers.Average(name="avg")([a, b]))
        m = keras.Model(inp, layers.Dense(4, activation="softmax",
                                          name="d1")(s))
        m.get_layer("bn_a").set_weights([
            np.random.RandomState(1).rand(3).astype(np.float32) + 0.5,
            np.random.RandomState(2).randn(3).astype(np.float32) * 0.1,
            np.random.RandomState(3).randn(3).astype(np.float32) * 0.2,
            np.random.RandomState(4).rand(3).astype(np.float32) + 0.5])
        x = np.random.RandomState(5).randn(4, 8, 8, 2).astype(np.float32)
        _check(_saved(m, tmp_path, "bnbranch.h5"), [x],
               m.predict(x, verbose=0))

    def test_two_inputs(self, keras, tmp_path):
        from keras import layers

        in_a = keras.Input((6,), name="in_a")
        in_b = keras.Input((6,), name="in_b")
        merged = layers.Concatenate(name="cat")([
            layers.Dense(5, activation="tanh", name="da")(in_a),
            layers.Dense(5, activation="relu", name="db")(in_b)])
        m = keras.Model([in_a, in_b], layers.Dense(
            3, activation="softmax", name="out")(merged))
        rs = np.random.RandomState(7)
        xa, xb = (rs.randn(3, 6).astype(np.float32) for _ in range(2))
        _check(_saved(m, tmp_path, "twoin.h5"), [xa, xb],
               m.predict([xa, xb], verbose=0))

    def test_linear_functional_stays_sequential(self, keras, tmp_path):
        from keras import layers

        inp = keras.Input((6,), name="in0")
        out = layers.Dense(3, activation="softmax", name="o1")(
            layers.Dense(8, activation="relu", name="h1")(inp))
        m = keras.Model(inp, out)
        x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
        _check(_saved(m, tmp_path, "linear.h5"), [x],
               m.predict(x, verbose=0), kind=MultiLayerNetwork)

    def test_two_input_disjoint_chains_not_flattened(self, keras, tmp_path):
        from keras import layers

        in_a, in_b = keras.Input((4,), name="ia"), keras.Input((6,),
                                                               name="ib")
        m = keras.Model([in_a, in_b], [
            layers.Dense(3, activation="softmax", name="oa")(in_a),
            layers.Dense(2, activation="softmax", name="ob")(in_b)])
        rs = np.random.RandomState(3)
        xa, xb = rs.randn(3, 4).astype(np.float32), \
            rs.randn(3, 6).astype(np.float32)
        _check(_saved(m, tmp_path, "disjoint.h5"), [xa, xb],
               list(m.predict([xa, xb], verbose=0)), kind=ComputationGraph)

    def test_single_input_multi_output_stays_functional(self, keras,
                                                        tmp_path):
        from keras import layers

        inp = keras.Input((5,), name="in0")
        mid = layers.Dense(4, activation="softmax", name="mid")(inp)
        fin = layers.Dense(2, activation="softmax", name="fin")(mid)
        m = keras.Model(inp, [mid, fin])
        x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
        _check(_saved(m, tmp_path, "multiout.h5"), [x],
               list(m.predict(x, verbose=0)), kind=ComputationGraph)

    def test_legacy_triple_inbound_format(self, tmp_path):
        rs = np.random.RandomState(11)
        W1, b1 = rs.randn(4, 4).astype(np.float32) * 0.4, \
            rs.randn(4).astype(np.float32) * 0.1
        W2, b2 = rs.randn(4, 3).astype(np.float32) * 0.4, \
            rs.randn(3).astype(np.float32) * 0.1
        path = str(tmp_path / "legacy.h5")
        _legacy(path, [
            {"class_name": "InputLayer", "name": "in0",
             "config": {"name": "in0", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "d1",
             "config": {"name": "d1", "units": 4, "activation": "tanh"},
             "inbound_nodes": [[["in0", 0, 0]]]},
            {"class_name": "Add", "name": "add", "config": {"name": "add"},
             "inbound_nodes": [[["in0", 0, 0], ["d1", 0, 0]]]},
            {"class_name": "Dense", "name": "d2",
             "config": {"name": "d2", "units": 3, "activation": "softmax"},
             "inbound_nodes": [[["add", 0, 0]]]}],
            [["in0", 0, 0]], [["d2", 0, 0]],
            {"d1": [("d1_W", W1), ("d1_b", b1)],
             "d2": [("d2_W", W2), ("d2_b", b2)]})
        x = rs.randn(5, 4).astype(np.float32)
        _check(path, [x], _softmax((x + np.tanh(x @ W1 + b1)) @ W2 + b2))

    def test_add_same_tensor_twice_imports_as_graph(self, tmp_path):
        rs = np.random.RandomState(17)
        W, b = rs.randn(4, 3).astype(np.float32) * 0.4, \
            rs.randn(3).astype(np.float32) * 0.1
        path = str(tmp_path / "add_same.h5")
        _legacy(path, [
            {"class_name": "InputLayer", "name": "in0",
             "config": {"name": "in0", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            {"class_name": "Add", "name": "dbl", "config": {"name": "dbl"},
             "inbound_nodes": [[["in0", 0, 0], ["in0", 0, 0]]]},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "units": 3, "activation": "softmax"},
             "inbound_nodes": [[["dbl", 0, 0]]]}],
            [["in0", 0, 0]], [["out", 0, 0]],
            {"out": [("out_W", W), ("out_b", b)]})
        x = rs.randn(5, 4).astype(np.float32)
        _check(path, [x], _softmax((2.0 * x) @ W + b),
               kind=ComputationGraph)

    def test_shared_layer_rejected(self, tmp_path):
        path = str(tmp_path / "shared.h5")
        _legacy(path, [
            {"class_name": "InputLayer", "name": "in0",
             "config": {"name": "in0", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "d1",
             "config": {"name": "d1", "units": 4},
             "inbound_nodes": [[["in0", 0, 0]], [["d2", 0, 0]]]},
            {"class_name": "Dense", "name": "d2",
             "config": {"name": "d2", "units": 4},
             "inbound_nodes": [[["d1", 0, 0]]]}],
            [["in0", 0, 0]], [["d1", 0, 0]], {})
        with pytest.raises(ValueError, match="shared"):
            timport.import_keras_model_and_weights(path, device=CPU)


class TestModelGuesser:
    def test_guesses_all_formats_as_jax(self, tmp_path):
        """A DL4J zip, both word-vector formats and an HDF5 file are
        sniffed as JAX sniffs them; each loads to what JAX's loads."""
        from deeplearning4j_torch.models.zoo import LeNet
        from deeplearning4j_torch.nlp import (CollectionSentenceIterator,
                                              Word2Vec)
        from deeplearning4j_torch.nlp.serde import (write_word2vec_binary,
                                                    write_word_vectors_text)
        from deeplearning4j_torch.utils.model_serializer import save_model

        net = LeNet().init(device=CPU)
        zp = str(tmp_path / "net.zip")
        save_model(net, zp)
        rs = np.random.RandomState(0)
        sents = [" ".join(f"w{rs.randint(20)}" for _ in range(8))
                 for _ in range(100)]
        w2v = Word2Vec(layer_size=8, window=2, min_word_frequency=1,
                       epochs=1, seed=1, device=CPU)
        w2v.fit(CollectionSentenceIterator(sents))
        bp, tp = str(tmp_path / "v.bin"), str(tmp_path / "v.txt")
        write_word2vec_binary(w2v, bp)
        write_word_vectors_text(w2v, tp)
        hp = str(tmp_path / "k1.h5")
        _K1()._write_k1_fixture(hp)
        kinds = {zp: "dl4j-zip", bp: "word2vec-binary",
                 tp: "word-vectors-text", hp: "keras-h5"}
        for p, kind in kinds.items():
            assert tguess.guess_format(p) == jguess.guess_format(p) == kind
        loaded = tguess.load_model_guess(zp, device=CPU)
        np.testing.assert_array_equal(loaded.params_flat(),
                                      net.params_flat())
        for p in (bp, tp):
            words, vecs = tguess.load_model_guess(p)
            jwords, jvecs = jguess.load_model_guess(p)
            assert words == jwords and np.array_equal(vecs, jvecs)
            assert len(words) == vecs.shape[0] == w2v.vocab.num_words()
        x = np.random.RandomState(5).randn(2, 6, 6, 2).astype(np.float32)
        np.testing.assert_allclose(
            _np(tguess.load_model_guess(hp, device=CPU).output(x)),
            np.asarray(jguess.load_model_guess(hp).output(x)),
            atol=JAX_ATOL)

    def test_committed_fixtures(self):
        """The round-4 conv-net zip and word vectors through the guesser,
        as ``tests/test_format_regression.py`` reads them."""
        fx = ROOT / "tests" / "fixtures"
        zp = str(fx / "regression_convnet_r4.zip")
        assert tguess.guess_format(zp) == "dl4j-zip"
        exp = np.load(fx / "regression_convnet_r4_expected.npz")
        net = tguess.load_model_guess(zp, device=CPU)
        np.testing.assert_allclose(float(net.params_flat().sum()),
                                   float(exp["params_sum"]), rtol=1e-5)
        bp = str(fx / "regression_vectors_r4.bin")
        assert tguess.guess_format(bp) == "word2vec-binary"
        words, vecs = tguess.load_model_guess(bp)
        np.testing.assert_allclose(
            vecs[words.index("w1")],
            np.load(fx / "regression_vectors_r4_expected.npz")["w1"],
            atol=1e-6)

    def test_unknown_rejected(self, tmp_path):
        p = tmp_path / "junk.bin"
        p.write_bytes(b"\x00\x01\x02\x03garbage")
        with pytest.raises(ValueError):
            tguess.guess_format(str(p))


class TestKerasBackendServer:
    def test_import_fit_evaluate_predict_over_http(self, keras, tmp_path):
        """``tests/test_ml_and_guesser.py``'s server case on both servers:
        a Keras file through ``/import``, twenty epochs of ``/fit``,
        ``/evaluate`` and ``/predict``; the port's scores within 1e-4 of
        JAX's, its accuracy JAX's, its rows within 1e-5."""
        import urllib.error
        import urllib.request

        from keras import layers

        from deeplearning4j_tpu.modelimport.server import \
            KerasBackendServer as JServer
        from deeplearning4j_torch.modelimport.server import \
            KerasBackendServer as TServer

        m = keras.Sequential([layers.Input((4,)),
                              layers.Dense(16, activation="relu"),
                              layers.Dense(3, activation="softmax")])
        m.compile(loss="categorical_crossentropy")
        h5 = _saved(m, tmp_path, "m.h5")
        rs = np.random.RandomState(0)
        paths = []
        for i in range(4):
            labels = rs.randint(0, 3, 32)
            p = str(tmp_path / f"b{i}.npz")
            np.savez(p, features=(rs.randn(32, 4) + 2 * labels[:, None])
                     .astype(np.float32),
                     labels=np.eye(3, dtype=np.float32)[labels])
            paths.append(p)
        results = []
        for srv in (JServer(), TServer(device=CPU)):
            base = f"http://127.0.0.1:{srv.start()}"

            def post(path, payload):
                req = urllib.request.Request(
                    base + path, json.dumps(payload).encode(),
                    {"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=120) as r:
                        return json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return json.loads(e.read())

            try:
                mid = post("/import", {"path": h5})["model"]
                fit = post("/fit", {"model": mid, "batches": paths,
                                    "epochs": 20})
                ev = post("/evaluate", {"model": mid, "batches": paths})
                out = post("/predict", {"model": mid,
                                        "features": [[0.0, 0.5, 1.0, 2.0]]})
                with urllib.request.urlopen(base + "/models",
                                            timeout=60) as r:
                    assert mid in json.loads(r.read())["models"]
                assert "error" in post("/fit", {"model": "nope",
                                                "batches": []})
            finally:
                srv.stop()
            results.append((fit, ev, np.asarray(out["output"])))
        (jfit, jev, jout), (tfit, tev, tout) = results
        assert tfit["iterations"] == jfit["iterations"] == 80
        np.testing.assert_allclose(tfit["score"], jfit["score"], rtol=1e-4)
        assert tev["accuracy"] == jev["accuracy"] and tev["accuracy"] > 0.8
        np.testing.assert_allclose(tout, jout, atol=1e-5)
