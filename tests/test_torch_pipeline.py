"""Port parity: GPipe pipeline training (the port's
``parallel/pipeline.py``) against one device and the JAX package's
``PipelineTrainer``, on the CPU — the counterpart of
``tests/test_pipeline.py``.

Stages live on the entries of a host list that names the CPU once per
stage; JAX's stages on its XLA CPU devices. Both packages start from the
same weights (the JAX net's, through ``params_from_jax``). Tolerances are
JAX's: the pipeline against one device at atol 1e-8 (SGD) and 1e-6
(Adam) on the flat parameters, the conv stack and the regularized /
clipped / per-layer-lr net at 1e-8; against JAX's pipeline 1e-6 (another
product order).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.nn import updater as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import builders as jb  # noqa: E402
from deeplearning4j_tpu.nn.conf import inputs as jin  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.parallel import pipeline as jpipe  # noqa: E402
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.nn import updater as tupd  # noqa: E402
from deeplearning4j_torch.nn.conf import builders as tb  # noqa: E402
from deeplearning4j_torch.nn.conf import inputs as tin  # noqa: E402
from deeplearning4j_torch.nn.conf import layers as tl  # noqa: E402
from deeplearning4j_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TMLN)
from deeplearning4j_torch.parallel.pipeline import (  # noqa: E402
    PipelineTrainer, balanced_stages)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def build(layers, input_type, updater, seed, configure=None):
    """(JAX net, the port's net on its weights) from one recipe."""
    def conf(b, L, inp, upd):
        bb = b.NeuralNetConfiguration.builder().seed(seed).updater(
            updater(upd))
        if configure is not None:
            bb = configure(bb)
        return bb.list(*layers(L)).set_input_type(input_type(inp)).build()

    jnet = JMLN(conf(jb, jl, jin, jupd)).init()
    tnet = TMLN(conf(tb, tl, tin, tupd)).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def mlp_layers(L):
    return [L.DenseLayer(n_out=32, activation="tanh"),
            L.DenseLayer(n_out=24, activation="relu"),
            L.DenseLayer(n_out=16, activation="tanh"),
            L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def mlp(updater):
    return build(mlp_layers, lambda m: m.InputType.feed_forward(6),
                 updater, 3)


def data(seed=0, n=32):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 3, n)
    return ((rs.randn(n, 6) + labels[:, None]).astype(np.float64),
            np.eye(3)[labels])


def stages_on(n):
    return [CPU] * n


def test_stages_cover_all_layers_as_jax():
    jnet, net = mlp(lambda u: u.Sgd(learning_rate=0.1))
    for n_stages in (2, 3, 4):
        stages = balanced_stages(net, n_stages)
        assert len(stages) == n_stages
        assert [i for st in stages for i in st] == list(range(4))
        assert stages == jpipe.balanced_stages(jnet, n_stages)


@pytest.mark.parametrize("upd,stages,micro,atol", [
    (lambda u: u.Sgd(learning_rate=0.1), 2, 4, 1e-8),
    (lambda u: u.Sgd(learning_rate=0.1), 4, 2, 1e-8),
    (lambda u: u.Adam(learning_rate=0.01), 2, 4, 1e-6),
])
def test_matches_single_device_and_jax(upd, stages, micro, atol):
    x, y = data()
    jnet, single = mlp(upd)
    _, pipe_net = mlp(upd)
    pt = PipelineTrainer(pipe_net, n_stages=stages, n_micro=micro,
                         devices=stages_on(stages))
    jpt = jpipe.PipelineTrainer(jnet, n_stages=stages, n_micro=micro)
    for _ in range(4):
        single.do_step(x, y)
        pt.do_step(x, y)
        jpt.do_step(x, y)
    pt._sync_back()
    jpt._sync_back()
    np.testing.assert_allclose(pipe_net.params_flat(), single.params_flat(),
                               atol=atol)
    np.testing.assert_allclose(pipe_net.params_flat(),
                               np.asarray(jnet.params_flat()), atol=1e-6)
    assert pt.iteration == 4 and pipe_net.iteration == 4
    assert abs(pt.score_value - jpt.score_value) < 1e-5


def test_fit_and_predict_through_wrapped_net():
    x, y = data(1, 64)
    _, net = mlp(lambda u: u.Adam(learning_rate=0.05))
    pt = PipelineTrainer(net, n_stages=2, n_micro=4, devices=stages_on(2))
    s0 = pt.do_step(x, y)
    for _ in range(29):
        pt.do_step(x, y)
    pt.fit(DataSet(x, y))
    assert pt.score_value < s0
    pred = np.argmax(net.output(x.astype(np.float32)).numpy(), 1)
    assert (pred == np.argmax(y, 1)).mean() > 0.8


def test_conv_stack_pipeline():
    def layers(L):
        return [L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                   activation="relu"),
                L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
                L.DenseLayer(n_out=16, activation="relu"),
                L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")]

    rs = np.random.RandomState(0)
    x = rs.randn(16, 8, 8, 1).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 16)]

    def make():
        return build(layers, lambda m: m.InputType.convolutional(8, 8, 1),
                     lambda u: u.Sgd(learning_rate=0.05), 5)[1]

    single, pnet = make(), make()
    pt = PipelineTrainer(pnet, n_stages=2, n_micro=4, devices=stages_on(2))
    for _ in range(3):
        single.do_step(x, y)
        pt.do_step(x, y)
    pt._sync_back()
    np.testing.assert_allclose(pnet.params_flat(), single.params_flat(),
                               atol=1e-8)


def test_regularization_clipping_and_layer_lr_parity():
    """l2 weight decay, gradient clipping and a per-layer learning rate
    flow through the pipeline exactly as on one device."""
    def layers(L):
        return [L.DenseLayer(n_out=24, activation="tanh"),
                L.DenseLayer(n_out=16, activation="relu",
                             learning_rate=0.02),
                L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]

    def configure(b):
        return (b.l2(1e-3).gradient_normalization("clip_l2_per_layer")
                .gradient_normalization_threshold(0.5))

    def make():
        return build(layers, lambda m: m.InputType.feed_forward(6),
                     lambda u: u.Sgd(learning_rate=0.1), 9, configure)

    x, y = data(7)
    _, single = make()
    jnet, pnet = make()
    pt = PipelineTrainer(pnet, n_stages=2, n_micro=4, devices=stages_on(2))
    jpt = jpipe.PipelineTrainer(jnet, n_stages=2, n_micro=4)
    for _ in range(4):
        single.do_step(x, y)
        pt.do_step(x, y)
        jpt.do_step(x, y)
    pt._sync_back()
    jpt._sync_back()
    np.testing.assert_allclose(pnet.params_flat(), single.params_flat(),
                               atol=1e-8)
    np.testing.assert_allclose(pnet.params_flat(),
                               np.asarray(jnet.params_flat()), atol=1e-6)


def test_dropout_is_active_under_pipeline():
    def layers(L):
        return [L.DenseLayer(n_out=64, activation="identity", dropout=0.5),
                L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]

    _, net = build(layers, lambda m: m.InputType.feed_forward(6),
                   lambda u: u.Sgd(learning_rate=0.0), 4)
    pt = PipelineTrainer(net, n_stages=2, n_micro=2, devices=stages_on(2))
    x, y = data(8, 16)
    losses = {round(pt.do_step(x, y), 10) for _ in range(4)}
    assert len(losses) > 1, "dropout inactive: identical losses"


def test_bn_running_stats_update_in_last_stage():
    def layers(L):
        return [L.DenseLayer(n_out=8, activation="relu"),
                L.BatchNormalization(),
                L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]

    jnet, net = build(layers, lambda m: m.InputType.feed_forward(6),
                      lambda u: u.Sgd(learning_rate=0.01), 6)
    pt = PipelineTrainer(net, n_stages=2, n_micro=2, devices=stages_on(2))
    jpt = jpipe.PipelineTrainer(jnet, n_stages=2, n_micro=2)
    bn_stage = next(s for s, idxs in enumerate(pt.stages) if 1 in idxs)
    assert bn_stage == len(pt.stages) - 1   # BN sits in the LAST stage
    x, y = data(9, 16)
    for _ in range(3):
        pt.do_step(x, y)
        jpt.do_step(x, y)
    pt._sync_back()
    jpt._sync_back()
    mean = net.state["1"]["mean"].numpy()
    assert not np.allclose(mean, 0.0), "BN running stats never updated"
    np.testing.assert_allclose(mean, np.asarray(jnet.state["1"]["mean"]),
                               atol=1e-6)


def test_indivisible_batch_rejected():
    _, net = mlp(lambda u: u.Sgd(learning_rate=0.1))
    pt = PipelineTrainer(net, n_stages=2, n_micro=4, devices=stages_on(2))
    x, y = data(2, 30)
    with pytest.raises(ValueError, match="not divisible"):
        pt.do_step(x, y)
    with pytest.raises(ValueError, match="need 3 devices"):
        PipelineTrainer(net, n_stages=3, devices=stages_on(2))
