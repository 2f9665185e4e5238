"""Rules the PyTorch port keeps:

- no file of ``deeplearning4j_torch/``, and not ``chip_smoke.py``, imports
  ``jax``, ``orbax`` or ``deeplearning4j_tpu``;
- entry points called with ``device=None`` raise on a host without CUDA
  instead of quietly running on the CPU;
- a kernel wrapper handed CUDA tensors on a host without CUDA raises, and
  never computes the plain version on the CPU instead; so does a CUDA case
  the kernels do not take (head dims under 4, over 128 or not a multiple of
  4, f64); the cases they take (head dims 4..128 that are multiples of 4;
  f32, bf16 and f16 for K1/K3/K4, and those queries over pages of their
  dtype or int8 for K2) reach the kernels' build;
- ``fit`` trains as the JAX package does: the fused K-step driver, the
  health guard and L2 regularization (held to JAX's ``fit`` here), and
  it stores ``conf.pretrain`` without reading it, as JAX's ``fit`` does;
- layer-wise ``pretrain``, ``DevicePrefetchIterator`` and the estimator
  wrappers run on CUDA unless the caller asks for the host;
- the recurrent entry points (``TextGenerationLSTM``, a TBPTT ``fit``,
  ``rnn_time_step``, ``greedy_generate``, ``EarlyStoppingTrainer`` and its
  ``LocalFileModelSaver``) run on CUDA unless the caller asks for the
  host;
- the serving fabric's entry points (``ParallelInference``,
  ``KerasBackendServer.attach_generation`` / ``attach_inference`` /
  ``attach_rag`` and the fleets they build) resolve their device through
  ``resolve_device``, and what is not ported yet (``mesh=``, ``workers >
  1``, ``tp > 1``, ``EmbeddingIndex(mesh=)``) raises naming its ROADMAP
  item;
- the NLP trainers (``Word2Vec.fit``, ``ParagraphVectors``, ``Glove``,
  ``DeepWalk``), ``load_word2vec`` and the Keras importers (with
  ``KerasBackendServer.import_model``) run on CUDA unless the caller asks
  for the host;
- the kernels' launch counters count exactly from many threads at once.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.nn.conf.layers import (  # noqa: E402
    attention as patt, paged_attention as ppa)
from deeplearning4j_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_torch.ops import random as prandom  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "orbax", "deeplearning4j_tpu")
TINY = dict(num_labels=11, max_length=8, d_model=32, n_heads=1, n_blocks=1,
            max_cache=32)


def _port_files():
    files = sorted((ROOT / "deeplearning4j_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    names = {str(p.relative_to(ROOT / "deeplearning4j_torch"))
             for p in files if "deeplearning4j_torch" in p.parts}
    # the training slice's modules and the serving runtime's copies are
    # covered too
    assert {"ops/losses.py", "nn/updater.py", "datasets/dataset.py",
            "optimize/fused_fit.py", "utils/convert.py",
            "parallel/handoff.py", "parallel/resilience.py",
            "parallel/runtime.py", "metrics/registry.py",
            "metrics/exposition.py", "metrics/__init__.py",
            "optimize/health.py", "optimize/listeners.py",
            "parallel/elastic.py", "nn/regularization.py",
            "nn/gradient_normalization.py", "nn/weights.py",
            "nn/conf/builders.py", "datasets/iterators.py",
            "nn/multilayer.py", "nn/network.py",
            "nn/conf/preprocessors.py", "nn/conf/layers/convolution.py",
            "nn/conf/layers/pooling.py", "nn/conf/layers/misc.py",
            "evaluation/classification.py", "evaluation/fused_eval.py",
            "datasets/mnist.py", "parallel/inference.py",
            "parallel/fleet.py", "parallel/mesh.py", "metrics/autoscale.py",
            "metrics/loadgen.py", "modelimport/__init__.py",
            "modelimport/server.py", "optimize/bucketing.py",
            "clustering/__init__.py", "clustering/kmeans.py",
            "clustering/kdtree.py", "clustering/vptree.py",
            "clustering/sptree.py", "nearestneighbors/__init__.py",
            "nearestneighbors/brute.py", "nearestneighbors/hnsw.py",
            "nearestneighbors/index.py", "nearestneighbors/server.py",
            "parallel/rag.py", "plot/__init__.py", "plot/tsne.py",
            "plot/barnes_hut.py", "nn/conf/layers/recurrent.py",
            "nn/conf/graph_conf.py", "models/zoo.py",
            "evaluation/__init__.py", "evaluation/binary.py",
            "evaluation/curves.py", "evaluation/regression.py",
            "evaluation/roc.py", "earlystopping/__init__.py",
            "earlystopping/config.py", "earlystopping/savers.py",
            "earlystopping/scorecalc.py", "earlystopping/termination.py",
            "earlystopping/trainer.py", "gradientcheck.py",
            "nn/transferlearning.py", "optimize/solvers.py",
            "nn/conf/layers/moe.py", "nn/conf/layers/__init__.py",
            "nn/simple.py", "nn/conf/layers/rbm.py",
            "nn/conf/layers/variational.py", "nn/conf/layers/core.py",
            "datasets/__init__.py", "datasets/curves.py",
            "datasets/cifar.py", "datasets/streaming.py",
            "optimize/accumulation.py", "ml.py", "native/__init__.py",
            "nlp/__init__.py", "nlp/tokenization.py", "nlp/vocab.py",
            "nlp/learning.py", "nlp/sequence_vectors.py",
            "nlp/word2vec.py", "nlp/paragraph_vectors.py", "nlp/glove.py",
            "nlp/bagofwords.py", "nlp/serde.py", "graph/__init__.py",
            "graph/graph.py", "graph/walks.py", "graph/deepwalk.py",
            "modelimport/keras.py", "utils/model_guesser.py",
            "datavec/__init__.py", "datavec/records.py",
            "datavec/iterators.py", "streaming/__init__.py",
            "streaming/serde.py", "streaming/broker.py",
            "streaming/client.py", "ui/__init__.py", "ui/storage.py",
            "ui/components.py", "ui/stats.py", "ui/remote.py",
            "ui/server.py", "ui/legacy.py", "parallel/__init__.py",
            "parallel/trainer.py", "parallel/evaluation.py",
            "parallel/early_stopping.py",
            "parallel/model_sharding.py", "parallel/federation.py"} <= names
    bad = [(str(p.relative_to(ROOT)), mod) for p in files
           for mod in _imported_roots(p) if mod in FORBIDDEN]
    assert bad == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**TINY).init()
    net = TransformerLM(**TINY).init(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationServer(net, 11)


def test_multilayer_entry_points_run_on_cuda_by_default(no_cuda):
    """The MultiLayerNetwork entry points (a zoo model's ``init``, a zip's
    ``load_model``, ``MultiLayerNetwork.init``) resolve to CUDA and, with
    no card, raise unless the caller asks for the host."""
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.utils.model_serializer import load_model

    fixture = str(ROOT / "tests" / "fixtures" / "regression_convnet_r4.zip")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeNet().init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(fixture)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(LeNet().conf()).init()
    assert LeNet().init(device="cpu").device.type == "cpu"
    assert load_model(fixture, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["ResNet50", "GoogLeNet",
                                  "FaceNetNN4Small2", "InceptionResNetV1"])
def test_graph_zoo_and_solver_run_on_cuda_by_default(name, no_cuda):
    """The graph zoo models' ``init`` resolves to CUDA and, with no card,
    raises unless the caller asks for the host; a ``Solver`` and a
    transfer-learning rebuild run where their net lives (its vectors and
    the rebuilt net's parameters on the net's device)."""
    from deeplearning4j_torch.models import zoo
    from deeplearning4j_torch.nn.transferlearning import TransferLearning
    from deeplearning4j_torch.optimize.solvers import Solver

    small = dict(num_labels=3, input_shape=(32, 32, 3))
    if name == "InceptionResNetV1":
        small["input_shape"] = (80, 80, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(zoo, name)(**small).init()
    if name != "ResNet50":
        return
    net = getattr(zoo, name)(**small).init(device="cpu")
    assert net.device.type == "cpu"
    lenet = zoo.LeNet().init(device="cpu")
    x = np.random.RandomState(0).rand(4, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[1, 2, 3, 4]]
    solver = Solver(lenet, algorithm="line_gradient_descent",
                    max_iterations=1)
    assert np.isfinite(solver.optimize(x, y))
    assert all(t.device.type == "cpu" for p in lenet.params.values()
               for t in p.values())
    rebuilt = (TransferLearning.GraphBuilder(net)
               .set_feature_extractor("res3a").build())
    assert rebuilt.device.type == "cpu"
    assert all(t.device.type == "cpu" for p in rebuilt.params.values()
               for t in p.values())


def test_pretrain_prefetch_and_estimators_run_on_cuda_by_default(no_cuda):
    """Layer-wise ``pretrain`` runs where its net lives (CUDA unless the
    net was built on the host), ``DevicePrefetchIterator`` and the
    estimator wrappers resolve CUDA and, with no card, raise unless the
    caller asks for the host."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.datasets.iterators import (
        DevicePrefetchIterator, ListDataSetIterator)
    from deeplearning4j_torch.ml import DL4JClassifier
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import OutputLayer, RBM
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Sgd

    def conf():
        return (NeuralNetConfiguration.builder().seed(1)
                .updater(Sgd(learning_rate=0.1))
                .list(RBM(n_out=5),
                      OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())

    rs = np.random.RandomState(0)
    x = (rs.rand(6, 4) > 0.5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf()).init()
    net = MultiLayerNetwork(conf()).init(device="cpu")
    net.pretrain(DataSet(x, None), epochs=2)
    assert all(t.device.type == "cpu" for t in net.params["0"].values())
    base = ListDataSetIterator(DataSet(x, y), batch_size=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetchIterator(base)
    placed = list(DevicePrefetchIterator(base, device="cpu"))
    assert all(torch.is_tensor(ds.features) for ds in placed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DL4JClassifier(conf, epochs=1).fit(x, y)
    clf = DL4JClassifier(conf, epochs=1, device="cpu").fit(x, y)
    assert clf.net_.device.type == "cpu"
    # sharded placement (once refused naming A11c) over a host mesh: each
    # batch's pieces live on the mesh's devices, and with no card a
    # default data mesh raises as the entry points do
    from deeplearning4j_torch.parallel.mesh import (DataSharding, Mesh,
                                                    data_mesh)
    sh = DataSharding(Mesh([torch.device("cpu")] * 3, ("data",)))
    placed = list(DevicePrefetchIterator(base, sharding=sh))
    assert all(p.device.type == "cpu" for ds in placed
               for p in ds.features.pieces)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_mesh()


def test_prng_key_lands_on_the_card(no_cuda):
    """``PRNGKey`` is an entry point: its key is made on the card, so with
    no CUDA device it raises unless the caller asks for the host."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prandom.PRNGKey(0)
    assert prandom.PRNGKey(0, device="cpu").device.type == "cpu"


def test_server_refuses_a_net_on_another_device():
    net = TransformerLM(**TINY).init(device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        GenerationServer(net, 11, device="meta")


def _no_plain(*_a, **_k):
    raise AssertionError("a CUDA request computed the plain version")


def test_flash_wrapper_on_cuda_tensors_raises_without_cuda(no_cuda,
                                                           monkeypatch):
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_forward(q, q, q, causal=True)


def test_flash_backward_on_cuda_tensors_raises_without_cuda(no_cuda,
                                                            monkeypatch):
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 32, device="cuda")
        lse = torch.empty(2, 16, 1, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_backward(q, q, q, q, lse, q, causal=True)


@pytest.mark.parametrize("case", ["d132", "d6", "d257", "d512", "f64"])
def test_flash_backward_refuses_unsupported_cases(case, no_cuda,
                                                  monkeypatch):
    """The backward wrapper checks the case before any build: a CUDA
    request the kernels cannot take (a head dim over 256, f64) raises
    instead of taking the plain version, and one they take (d = 132 and 6,
    since ROADMAP B3 (a) and (b)) goes to the kernels' build, which raises
    on a host without CUDA."""
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    d, dtype, err, match = {"d132": (132, torch.float32, RuntimeError,
                                     "CUDA device"),
                            "d6": (6, torch.float32, RuntimeError,
                                   "CUDA device"),
                            "d257": (257, torch.float32, ValueError,
                                     "head dims 1..256"),
                            "d512": (512, torch.float32, ValueError,
                                     "head dims 1..256"),
                            "f64": (32, torch.float64, TypeError,
                                    "f32, bf16 or f16")}[case]
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, d, device="cuda", dtype=dtype)
        lse = torch.empty(2, 16, 1, device="cuda")
        with pytest.raises(err, match=match):
            fa.flash_attention_backward(q, q, q, q, lse, q)


@pytest.mark.parametrize("what", ["pretrain"])
def test_fit_refuses_what_is_not_ported(what):
    """``conf.pretrain`` is stored and not read by ``fit`` (C13, as in the
    JAX package, whose ``fit`` never reads it): a net with the flag set
    fits to the parameters of the same net without it, bit for bit, and
    to JAX's with the flag set (1e-5)."""
    import jax

    from deeplearning4j_torch.utils.convert import params_to_numpy

    j, flagged = _jax_and_port(updater=0.1)
    _, plain = _jax_and_port(updater=0.1)
    (x, y), = _stream(1)
    setattr(flagged.conf, what, True)
    setattr(j.conf, what, True)
    for net in (j, flagged, plain):
        net.fit(x, y, epochs=2)
    assert flagged.iteration == plain.iteration == j.iteration == 2
    np.testing.assert_array_equal(flagged.params_flat(), plain.params_flat())
    ref = jax.device_get(j.params)
    got = params_to_numpy(flagged)
    for v in ref:
        for k in ref[v]:
            np.testing.assert_allclose(got[v][k], ref[v][k], atol=1e-5,
                                       rtol=0, err_msg=f"{v}.{k}")


TEXTGEN = dict(num_labels=11, max_length=8)


def _textgen_batch(T=12):
    eye = np.eye(11, dtype=np.float32)
    tok = np.random.RandomState(4).randint(0, 11, (2, T + 1))
    return eye[tok[:, :-1]], eye[tok[:, 1:]]


def test_recurrent_entry_points_run_on_cuda_by_default(no_cuda, tmp_path):
    """``TextGenerationLSTM.init``, a recurrent layer's net, ``load_model``
    of its zip and ``LocalFileModelSaver`` resolve to CUDA and, with no
    card, raise unless the caller asks for the host; on the host a TBPTT
    ``fit`` (one step per segment), ``rnn_time_step``, ``greedy_generate``
    and ``EarlyStoppingTrainer`` run where the net lives."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition)
    from deeplearning4j_torch.models.zoo import (TextGenerationLSTM,
                                                 greedy_generate)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.utils.model_serializer import (load_model,
                                                             save_model)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextGenerationLSTM(**TEXTGEN).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(TextGenerationLSTM(**TEXTGEN).conf()).init()
    net = TextGenerationLSTM(**TEXTGEN).init(device="cpu")
    x, y = _textgen_batch(T=120)
    net.fit(x, y)
    assert net.iteration == 3                     # segments of 50, 50, 20
    assert all(t.device.type == "cpu" for p in net.params.values()
               for t in p.values())
    assert net.rnn_time_step(x[:, :3]).device.type == "cpu"
    assert greedy_generate(net, np.zeros((1, 2), int), 3, 11).shape == (1, 3)
    path = str(tmp_path / "textgen.zip")
    save_model(net, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(path)
    assert load_model(path, device="cpu").device.type == "cpu"

    def run(saver):
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(1)],
            score_calculator=DataSetLossCalculator([DataSet(x, y)]),
            model_saver=saver)
        return EarlyStoppingTrainer(cfg, net, [DataSet(x, y)]).fit()

    # the saver reads its best zip back onto CUDA unless told otherwise
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(LocalFileModelSaver(str(tmp_path / "es")))
    assert net.iteration == 6
    res = run(LocalFileModelSaver(str(tmp_path / "es"), device="cpu"))
    assert res.termination_reason == "EpochTerminationCondition"
    assert net.iteration == 9
    assert res.best_model.device.type == "cpu"


@pytest.mark.parametrize("layer", ["LSTM", "GravesLSTM",
                                   "GravesBidirectionalLSTM", "SimpleRnn"])
def test_recurrent_layer_nets_run_on_cuda_by_default(no_cuda, layer):
    """A net of each recurrent layer resolves to CUDA; on the host its
    TBPTT ``fit`` trains."""
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import recurrent
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(1)
            .list(getattr(recurrent, layer)(n_out=4),
                  recurrent.RnnOutputLayer(n_out=11))
            .set_input_type(InputType.recurrent(11))
            .t_bptt_lengths(5).build())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf).init()
    net = MultiLayerNetwork(conf).init(device="cpu")
    before = net.params_flat()
    net.fit(*_textgen_batch(T=12))
    assert net.iteration == 3
    assert not np.array_equal(net.params_flat(), before)


def _jax_and_port(updater=None, l2=None):
    """A JAX and a port TINY TransformerLM on the JAX net's weights (Sgd
    with ``updater``'s rate, and L2 on the FFN layers, when given)."""
    import jax

    from deeplearning4j_tpu.models.zoo import TransformerLM as JaxLM
    from deeplearning4j_tpu.nn import updater as jup
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
    from deeplearning4j_torch.nn import updater as tup
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.utils.convert import params_from_jax

    kw = {k: v for k, v in TINY.items() if k != "max_cache"}
    jconf, tconf = JaxLM(**kw).conf(), TransformerLM(**TINY).conf()
    if updater is not None:
        jconf.updater = jup.Sgd(learning_rate=updater)
        tconf.updater = tup.Sgd(learning_rate=updater)
    for c in (jconf, tconf):
        for name, v in c.vertices.items():
            if l2 is not None and name.startswith("ff"):
                v.layer.l2 = l2
    j = JaxGraph(jconf).init()
    t = ComputationGraph(tconf).init(device="cpu")
    params_from_jax(jax.device_get(j.params), t)
    return j, t


def _stream(n, nan_at=None):
    rs = np.random.RandomState(21)
    tok = rs.randint(0, 11, (n, 2, 9))
    eye = np.eye(11, dtype=np.float32)
    out = []
    for i in range(n):
        x, y = eye[tok[i, :, :-1]], eye[tok[i, :, 1:]]
        if i == nan_at:
            x = x.copy()
            x[0, 0, 0] = np.nan
        out.append((x, y))
    return out


@pytest.mark.parametrize("kw", ["fused2", "guard_on", "guard_policy"])
def test_fit_options_match_jax(kw):
    """What the refusals stood for: ``fused_steps=2``, ``health_guard=True``
    and a ``HealthPolicy`` train as JAX's ``fit`` with the same options
    (a NaN batch mid-stream under the guard), losses and params within
    1e-5."""
    import jax

    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu.optimize.health import HealthPolicy as JaxPolicy
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.optimize.health import HealthPolicy
    from deeplearning4j_torch.utils.convert import params_to_numpy

    j, t = _jax_and_port(updater=0.1)
    nan_at = None if kw == "fused2" else 1
    batches = _stream(4, nan_at)
    opts = {"fused2": (dict(fused_steps=2, health_guard=None),) * 2,
            "guard_on": (dict(fused_steps=1, health_guard=True),) * 2,
            "guard_policy": (
                dict(fused_steps=1, health_guard=JaxPolicy(skip_threshold=3)),
                dict(fused_steps=1,
                     health_guard=HealthPolicy(skip_threshold=3)))}[kw]
    j.fit([JaxDataSet(x, y) for x, y in batches], **opts[0])
    t.fit([DataSet(x, y) for x, y in batches], **opts[1])
    assert t.iteration == j.iteration == 4
    ref = jax.device_get(j.params)
    got = params_to_numpy(t)
    assert np.isfinite(t.params_flat()).all()
    for v in ref:
        for k in ref[v]:
            np.testing.assert_allclose(got[v][k], ref[v][k], atol=1e-5,
                                       rtol=0, err_msg=f"{v}.{k}")
    assert t.score() == pytest.approx(float(j.score_value), abs=1e-5)


def test_step_with_l2_matches_jax():
    """L2 on the FFN layers trains as JAX's: the reported loss carries the
    penalty and three Sgd steps end on JAX's params within 1e-5."""
    import jax

    from deeplearning4j_torch.utils.convert import params_to_numpy

    j, t = _jax_and_port(updater=0.1, l2=0.05)
    (x, y), = _stream(1)
    for _ in range(3):
        jl = float(j.do_step([x], [y])[0])
        tl = float(t.do_step([x], [y])[0])
        assert tl == pytest.approx(jl, rel=1e-5)
    ref = jax.device_get(j.params)
    got = params_to_numpy(t)
    for v in ref:
        for k in ref[v]:
            np.testing.assert_allclose(got[v][k], ref[v][k], atol=1e-5,
                                       rtol=0, err_msg=f"{v}.{k}")


def test_paged_wrapper_on_cuda_tensors_raises_without_cuda(no_cuda,
                                                           monkeypatch):
    monkeypatch.setattr(ppa, "paged_attention_plain", _no_plain)
    with FakeTensorMode():
        q = torch.empty(2, 2, 1, 32, device="cuda")
        pool = torch.empty(5, 2, 8, 32, device="cuda")
        bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attention(q, pool, pool, bt, pos)


def test_cuda_wrappers_refuse_unsupported_shapes():
    """Shape and type checks come before any build: a CUDA request the
    kernel cannot take raises instead of taking the plain version."""
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 257, device="cuda")          # d = 257
        with pytest.raises(ValueError, match="head dims 1..256"):
            fa.flash_attention_forward(q, q, q)
        q64 = torch.empty(1, 2, 16, 32, device="cuda", dtype=torch.float64)
        with pytest.raises(TypeError, match="f32, bf16 or f16"):
            fa.flash_attention_forward(q64, q64, q64)
        qd = torch.empty(1, 2, 1, 32, device="cuda", dtype=torch.float64)
        with pytest.raises(TypeError, match="paged kernel takes a query"):
            ppa.paged_attention(qd, qd, qd, qd, qd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_16bit_paged_query_on_cuda_reaches_the_kernel(dtype, no_cuda,
                                                      monkeypatch):
    """A bf16 (or f16) model's paged read on CUDA tensors goes to K2's
    build, through the backend the layer's ``auto`` knob resolves to as
    through the wrapper, and never to the plain version: on a host
    without CUDA the build raises."""
    monkeypatch.setattr(ppa, "paged_attention_plain", _no_plain)
    layer = patt.SelfAttentionLayer(n_in=64, n_out=64, n_heads=2,
                                    causal=True)
    assert ppa.resolve_paged_backend(layer.paged_attention,
                                     "cuda") == "pallas"
    with FakeTensorMode():
        q = torch.empty(2, 2, 1, 32, device="cuda", dtype=dtype)
        pool = torch.empty(5, 2, 8, 32, device="cuda", dtype=dtype)
        bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attention(q, pool, pool, bt, pos)
        backend = ppa.resolve_paged_backend(layer.paged_attention, q.device)
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attend(backend, q, pool, pool, bt, pos)


@pytest.mark.parametrize("helper", ["auto", "pallas"])
@pytest.mark.parametrize("case", ["d48", "d132", "d257", "f16", "mask3d"])
def test_attention_layer_on_cuda_never_takes_the_plain_path(
        case, helper, no_cuda, monkeypatch):
    """The layer's kernel-routed helpers hand CUDA tensors to K1's wrapper
    whatever their shape or type, so a case the kernel cannot take (d=257,
    a 3-D mask) raises instead of computing ``scaled_dot_attention`` on the
    card, and one it takes (d=48 and d=132 padded, f16) goes to the
    kernel's build, which raises on a host without CUDA."""
    monkeypatch.setattr(patt, "scaled_dot_attention", _no_plain)
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    refused = dict(expected_exception=(ValueError, TypeError))
    built = dict(expected_exception=RuntimeError, match="CUDA device")
    d, dtype, mask_shape, raises = {
        "d48": (48, torch.float32, (1, 16), built),
        "d132": (132, torch.float32, (1, 16), built),
        "d257": (257, torch.float32, (1, 16), refused),
        "f16": (32, torch.float16, (1, 16), built),
        "mask3d": (32, torch.float32, (1, 2, 16), refused)}[case]
    layer = patt.SelfAttentionLayer(n_in=2 * d, n_out=2 * d, n_heads=2,
                                    causal=True, helper=helper)
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, d, device="cuda", dtype=dtype)
        mask = torch.ones(mask_shape, device="cuda")
        with pytest.raises(**raises):
            layer._attend(q, q, q, mask)


def test_output_stays_on_the_requested_device():
    net = TransformerLM(**TINY).init(device="cpu")
    x = np.eye(11, dtype=np.float32)[np.arange(8) % 11][None]
    out = net.output(x)
    assert out.device.type == "cpu" and out.shape == (1, 8, 11)


@pytest.mark.parametrize("d, dtype", [(8, torch.float32), (8, torch.bfloat16),
                                      (8, torch.float16), (16, torch.float32),
                                      (16, torch.float16), (32, torch.float16),
                                      (128, torch.float16)],
                         ids=["d8f32", "d8bf16", "d8f16", "d16f32", "d16f16",
                              "d32f16", "d128f16"])
def test_flash_case_table_takes_small_head_dims_and_f16(d, dtype, no_cuda,
                                                        monkeypatch):
    """K1/K3/K4's CUDA case table takes head dims 8 and 16 and f16: the
    shape and type check passes (``supports`` agrees) and the wrappers go on
    to the kernels' build, which raises on a host without CUDA, never to
    the plain version."""
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    assert fa.supports((2, 2, 16, d), mask=None, dtype=dtype)
    with FakeTensorMode():
        q = torch.empty(2, 2, 16, d, device="cuda", dtype=dtype)
        m = torch.ones(2, 16, device="cuda")
        assert fa._cuda_case(q, q, q, m).shape == (2, 16)
        lse = torch.empty(4, 16, 1, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_forward(q, q, q, causal=True, mask=m)
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_backward(q, q, q, q, lse, q, causal=True)


@pytest.mark.parametrize("d", [2, 6, 132, 256, 257, 512])
def test_case_tables_refuse_other_head_dims(d, no_cuda, monkeypatch):
    """Head dims over 256 (what is left of ROADMAP B3, (c)) raise on CUDA
    tensors in both case tables before any build, naming the rule; every
    head dim 1..256 (2, 6, 132, 256: B3 (a) and (b)) passes both and goes
    to the kernels' build, which raises on a host without CUDA, never to
    the plain versions."""
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    monkeypatch.setattr(ppa, "paged_attention_plain", _no_plain)
    taken = d <= 256
    assert fa.supports((2, 2, 16, d), mask=None) == taken
    raises = (dict(expected_exception=RuntimeError, match="CUDA device")
              if taken else dict(expected_exception=ValueError,
                                 match="head dims 1..256"))
    with FakeTensorMode():
        q = torch.empty(2, 2, 16, d, device="cuda")
        if taken:
            assert fa._cuda_case(q, q, q, None) is None
        with pytest.raises(**raises):
            fa.flash_attention_forward(q, q, q, causal=True)
        qp = torch.empty(2, 2, 1, d, device="cuda")
        pool = torch.empty(5, 2, 8, d, device="cuda")
        bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(**raises):
            ppa.paged_attention(qp, pool, pool, bt, pos)


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["own", "int8"])
def test_paged_small_head_dims_reach_the_kernel(d, quant, no_cuda,
                                                monkeypatch):
    """K2 takes head dims 8 and 16 over pages of the query's dtype or int8:
    the wrapper goes to the kernel's build (raising without CUDA)."""
    monkeypatch.setattr(ppa, "paged_attention_plain", _no_plain)
    with FakeTensorMode():
        q = torch.empty(2, 2, 1, d, device="cuda", dtype=torch.float16)
        pool = torch.empty(5, 2, 8, d, device="cuda",
                           dtype=torch.int8 if quant else torch.float16)
        sc = torch.empty(5, 2, 8, device="cuda") if quant else None
        bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attention(q, pool, pool, bt, pos, kscales=sc,
                                vscales=sc)


@pytest.mark.parametrize("d", [4, 12, 48, 80, 96, 120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_flash_case_table_takes_padded_head_dims(d, dtype, no_cuda,
                                                 monkeypatch):
    """K1/K3/K4 take every head dim 4..128 that is a multiple of 4 (a
    padded instantiation where the width has none of its own): the case
    check passes and the wrappers go on to the kernels' build, which raises
    on a host without CUDA, never to the plain version."""
    from deeplearning4j_torch import kernels

    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    monkeypatch.setattr(fa, "flash_attention_backward_plain", _no_plain)
    assert fa.supports((2, 2, 16, d), mask=None, dtype=dtype)
    width = kernels.kernel_width(d)
    assert width in kernels.KERNEL_WIDTHS and d <= width < d + 16
    with FakeTensorMode():
        q = torch.empty(2, 2, 16, d, device="cuda", dtype=dtype)
        m = torch.ones(2, 16, device="cuda")
        lse = torch.empty(4, 16, 1, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_forward(q, q, q, causal=True, mask=m)
        with pytest.raises(RuntimeError, match="CUDA device"):
            fa.flash_attention_backward(q, q, q, q, lse, q, causal=True)


@pytest.mark.parametrize("d", [4, 48, 96])
@pytest.mark.parametrize("T", [1, 4, 48], ids=["T1", "T4", "T48"])
@pytest.mark.parametrize("quant", [False, True], ids=["own", "int8"])
def test_paged_padded_head_dims_reach_the_kernel(d, T, quant, no_cuda,
                                                 monkeypatch):
    """K2 takes head dims 4, 48 and 96 on both routes (T <= 4 decode, T > 4
    chunk) over pages of the query's dtype or int8: the wrapper goes to the
    kernel's build (raising without CUDA), never to the plain version; the
    decode route pads to a power of two, the chunk route to the next
    kernel width."""
    from deeplearning4j_torch import kernels

    monkeypatch.setattr(ppa, "paged_attention_plain", _no_plain)
    assert kernels.decode_width(d) == {4: 8, 48: 64, 96: 128}[d]
    assert kernels.kernel_width(d) == {4: 8, 48: 48, 96: 96}[d]
    with FakeTensorMode():
        q = torch.empty(2, 2, T, d, device="cuda", dtype=torch.bfloat16)
        pool = torch.empty(5, 2, 8, d, device="cuda",
                           dtype=torch.int8 if quant else torch.bfloat16)
        sc = torch.empty(5, 2, 8, device="cuda") if quant else None
        bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        pos = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            ppa.paged_attention(q, pool, pool, bt, pos, kscales=sc,
                                vscales=sc)


# ------------------------------------------------------- the serving fabric
def _mln_on(device):
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import OutputLayer
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(1)
            .list(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init(device=device)


def test_fabric_entry_points_run_on_cuda_by_default(no_cuda):
    """``ParallelInference`` and the HTTP server's ``attach_*`` (with the
    fleets they build) resolve to CUDA and, with no card, raise unless the
    caller asks for the host; a net on another device is refused."""
    from deeplearning4j_torch.modelimport.server import KerasBackendServer
    from deeplearning4j_torch.parallel.inference import ParallelInference

    net, lm = _mln_on("cpu"), TransformerLM(**TINY).init(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelInference(net)
    srv = KerasBackendServer()
    try:
        for call in (lambda: srv.attach_inference(net),
                     lambda: srv.attach_inference(net, replicas=2),
                     lambda: srv.attach_generation(lm, vocab=11),
                     lambda: srv.attach_generation(lm, vocab=11,
                                                   replicas=2),
                     lambda: srv.attach_rag(lm, vocab=11, passages=[[1]],
                                            doc_vectors=np.eye(2))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        with ParallelInference(net, device="cpu") as inf:
            assert inf.device.type == "cpu"
        with pytest.raises(ValueError, match="lives on"):
            ParallelInference(net, device="meta")
        mid = srv.attach_inference(net, replicas=2, device="cpu")
        fleet = srv._inference[mid]
        assert all(r.server.device.type == "cpu" for r in fleet._replicas)
        gid = srv.attach_generation(lm, vocab=11, replicas=2, device="cpu")
        assert all(r.server.device.type == "cpu"
                   for r in srv._generators[gid]._replicas)
        rid = srv.attach_rag(lm, vocab=11, passages=[[1], [2]],
                             doc_vectors=np.eye(2), device="cpu")
        assert all(r.server.device.type == "cpu"
                   for r in srv._rags[rid].fleet._replicas)
    finally:
        srv.stop()


def test_fabric_parts_not_ported_raise_naming_their_item(tmp_path):
    """The mesh-sharded retrieval stores (``EmbeddingIndex(mesh=)``,
    ``kmeans="sharded"``, ``NearestNeighborsServer(mesh=)``), ``mesh=``,
    ``workers > 1`` and ``tp > 1`` are ported (they named A9 before): a
    mesh of another type is refused, ``workers`` and ``tp``
    count the CUDA devices and never reuse the host or one card, and a
    host mesh serves; ``/import`` is ported and returns a model id."""
    from deeplearning4j_torch.nearestneighbors import NearestNeighborsServer
    from deeplearning4j_torch.nearestneighbors.index import EmbeddingIndex
    from deeplearning4j_torch.modelimport.server import KerasBackendServer
    from deeplearning4j_torch.parallel.fleet import device_groups
    from deeplearning4j_torch.parallel.inference import ParallelInference
    from deeplearning4j_torch.parallel.mesh import Mesh, MeshGeometryError

    net = _mln_on("cpu")
    cpu = torch.device("cpu")
    ndev = torch.cuda.device_count()
    with pytest.raises(TypeError, match="Mesh"):
        ParallelInference(net, device="cpu", mesh=object())
    for w in (ndev + 1, ndev + 8):
        with pytest.raises(ValueError, match=f"Requested {w} devices"):
            ParallelInference(net, device="cpu", workers=w)
    with ParallelInference(net, mesh=Mesh([cpu] * 2, ("data",))) as inf:
        assert inf.workers == 2 and inf.device == cpu
    assert device_groups(1, 2, devices=[cpu] * 2) == [[cpu, cpu]]
    with pytest.raises(MeshGeometryError, match="exceeds"):
        GenerationServer(TransformerLM(**TINY).init(device="cpu"), 11,
                         tp=ndev + 2, device="cpu")
    pts = np.arange(8, dtype=np.float32).reshape(4, 2)
    for make in (lambda: EmbeddingIndex(pts, mesh=object(), device="cpu"),
                 lambda: NearestNeighborsServer(pts, backend="index",
                                                mesh=object(),
                                                device="cpu")):
        with pytest.raises(TypeError, match="Mesh"):
            make()
    with pytest.raises(ValueError, match="requires a mesh"):
        EmbeddingIndex(pts, partitions=2, kmeans="sharded", device="cpu")
    host2 = Mesh([cpu] * 2, ("data",))
    with EmbeddingIndex(pts, partitions=2, kmeans="sharded",
                        mesh=host2) as index:
        assert index.stats()["probe_local"] is True
        assert index.search_batch_arrays(pts[:1], 1)[1].tolist() == [[0]]
    with NearestNeighborsServer(pts, backend="index", mesh=host2) as srv:
        assert srv.index.stats()["variant"] == "aux"
    # /import is ported (it named ROADMAP A12 before): on the CPU it
    # returns a model id whose net lives there
    pytest.importorskip("h5py")
    from tests.test_modelimport import TestKeras1StyleImport

    srv = KerasBackendServer(device="cpu")
    path = str(tmp_path / "k1.h5")
    TestKeras1StyleImport()._write_k1_fixture(path)
    mid = srv.import_model(path)
    assert mid in srv._models and srv._models[mid].device.type == "cpu"


def test_nlp_and_keras_entry_points_run_on_cuda_by_default(no_cuda,
                                                          tmp_path):
    """``Word2Vec.fit`` (device and native routes), ``ParagraphVectors``,
    ``Glove``, ``DeepWalk``, ``load_word2vec``, the Keras importers and
    ``KerasBackendServer.import_model`` resolve CUDA and, with no card,
    raise unless the caller asks for the host; asked for the host, their
    tables and nets live there. On a card the default ``"auto"`` backend
    keeps negative-sampling tables there: only ``backend="native"`` or
    the host takes the C loop."""
    from deeplearning4j_torch.graph import DeepWalk, Graph
    from deeplearning4j_torch.modelimport import (
        import_keras_model_and_weights,
        import_keras_sequential_model_and_weights)
    from deeplearning4j_torch.modelimport.server import KerasBackendServer
    from deeplearning4j_torch.nlp import Glove, ParagraphVectors, Word2Vec
    from deeplearning4j_torch.nlp.serde import (load_word2vec,
                                                write_word2vec_binary)
    from deeplearning4j_torch.nlp.tokenization import LabelledDocument

    sents = ["a b c a b", "b c d e", "c d e a"] * 4
    docs = [LabelledDocument(t, l) for t, l in (("a b c", "X"),
                                                ("d e a", "Y"))] * 3
    graph = Graph.from_edges(4, [(0, 1), (1, 2), (2, 3)])
    makers = {
        "device": lambda **d: Word2Vec(layer_size=4, negative=2, epochs=1,
                                       backend="device", **d).fit(sents),
        "native": lambda **d: Word2Vec(layer_size=4, negative=2, epochs=1,
                                       use_hierarchic_softmax=False,
                                       **d).fit(sents),
        "pv": lambda **d: ParagraphVectors(layer_size=4, negative=2,
                                           epochs=1, **d).fit(docs),
        "glove": lambda **d: Glove(layer_size=4, epochs=1, **d).fit(sents),
        "deepwalk": lambda **d: DeepWalk(vector_size=4, walk_length=4,
                                         walks_per_vertex=1, **d).fit(graph),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        m = make(device="cpu")
        table = m._sv.syn0 if name == "deepwalk" else m.syn0
        assert (isinstance(table, np.ndarray) if name == "native"
                else table.device.type == "cpu"), name
    ns = dict(layer_size=4, negative=2, use_hierarchic_softmax=False)
    for cls in (Word2Vec, ParagraphVectors):
        assert not cls(device="cuda", **ns)._use_native_backend(), cls
        assert cls(backend="native", device="cuda",
                   **ns)._use_native_backend(), cls
        assert cls(device="cpu", **ns)._use_native_backend(), cls
    vec = str(tmp_path / "v.bin")
    write_word2vec_binary(makers["device"](device="cpu"), vec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_word2vec(vec)
    assert load_word2vec(vec, device="cpu").syn0.device.type == "cpu"
    pytest.importorskip("h5py")
    from tests.test_modelimport import TestKeras1StyleImport

    h5 = str(tmp_path / "k1.h5")
    TestKeras1StyleImport()._write_k1_fixture(h5)
    for imp in (import_keras_model_and_weights,
                import_keras_sequential_model_and_weights):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            imp(h5)
        assert imp(h5, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasBackendServer().import_model(h5)


def test_launch_counters_are_exact_across_threads():
    """Eight threads count 10,000 launches each at once (fleet replicas
    count K2 launches from their own loop threads): the totals are exact,
    and a reset under the same lock clears them."""
    import sys
    import threading

    from deeplearning4j_torch import kernels

    saved = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BY_D)
    interval = sys.getswitchinterval()
    kernels.reset_launch_counts()
    start = threading.Event()

    def count():
        start.wait(10)
        for _ in range(10_000):
            kernels.count_launch("paged_attn", 32)

    threads = [threading.Thread(target=count) for _ in range(8)]
    try:
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        start.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["paged_attn"] == 80_000
        assert kernels.LAUNCHES_BY_D[("paged_attn", 32)] == 80_000
        kernels.reset_launch_counts()
        assert not any(kernels.LAUNCHES.values())
        assert kernels.LAUNCHES_BY_D == {}
    finally:
        sys.setswitchinterval(interval)
        kernels.LAUNCHES.update(saved[0])
        kernels.LAUNCHES_BY_D.clear()
        kernels.LAUNCHES_BY_D.update(saved[1])
