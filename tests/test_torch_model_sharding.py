"""Port parity: dp x tp ``ShardedTrainer`` (the port's
``parallel/model_sharding.py``) against the JAX package's on the CPU — the
counterpart of ``tests/test_model_sharding.py`` and of
``tests/test_moe.py::TestExpertParallel``.

The port stores each leaf as one piece per mesh entry (1/m of a sharded
leaf on each model entry) and runs the layers partitioned as GSPMD does
under JAX's specs (column-parallel dense and convolution, attention on
``H/m`` heads, experts on their entries). Meshes name the CPU several
times (``data_model_mesh(2, 2, devices=[cpu] * 4)``); JAX's run over its
XLA CPU devices. Tolerances are JAX's: dp x tp against one device at
rtol 2e-4 / atol 2e-5 (the TransformerLM rtol 5e-4 / atol 1e-5, the MoE
atol 1e-5); the port's one-device steps are held to JAX's at the same
tolerances, from the same weights.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet)
from deeplearning4j_tpu.nn import updater as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import builders as jb  # noqa: E402
from deeplearning4j_tpu.nn.conf import inputs as jin  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.parallel import model_sharding as jms  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import (  # noqa: E402
    data_model_mesh as jdata_model_mesh)
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.nn import updater as tupd  # noqa: E402
from deeplearning4j_torch.nn.conf import builders as tb  # noqa: E402
from deeplearning4j_torch.nn.conf import inputs as tin  # noqa: E402
from deeplearning4j_torch.nn.conf import layers as tl  # noqa: E402
from deeplearning4j_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TMLN)
from deeplearning4j_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_torch.parallel.mesh import (  # noqa: E402
    MODEL_AXIS, Mesh, data_model_mesh)
from deeplearning4j_torch.parallel.model_sharding import (  # noqa: E402
    P, ShardedTensor, ShardedTrainer, SpecTensor, _entry_grid,
    network_param_specs, shard_network)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mesh(data=2, model=2):
    return data_model_mesh(data, model, devices=[CPU] * (data * model))


def pair(layers, input_type, updater, seed=7):
    """The JAX net and the port's on its weights, built from one recipe
    (``layers(pkg)``, ``updater(pkg)``)."""
    jconf = (jb.NeuralNetConfiguration.builder().seed(seed)
             .updater(updater(jupd)).list(*layers(jl))
             .set_input_type(input_type(jin)).build())
    tconf = (tb.NeuralNetConfiguration.builder().seed(seed)
             .updater(updater(tupd)).list(*layers(tl))
             .set_input_type(input_type(tin)).build())
    jnet = JMLN(jconf).init()
    tnet = TMLN(tconf).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def cnn_layers(L):
    return [L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                               activation="relu"),
            L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
            L.DenseLayer(n_out=16, activation="relu"),
            L.OutputLayer(n_out=4, activation="softmax", loss="mcxent")]


def cnn_pair():
    return pair(cnn_layers, lambda m: m.InputType.convolutional(12, 12, 1),
                lambda u: u.Adam(learning_rate=1e-3))


def batches(n=3, b=4, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, 12, 12, 1).astype(np.float32),
             np.eye(4, dtype=np.float32)[rs.randint(0, 4, b)])
            for _ in range(n)]


def assert_trees_close(got, want, **tol):
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(np.asarray(got[k][n]),
                                       np.asarray(want[k][n]),
                                       err_msg=f"{k}/{n}", **tol)


def lm_pair(V, T, n_heads, seed):
    """The JAX zoo ``TransformerLM`` (d_model 16, 1 block) and a maker of
    port nets on its weights, with fresh Adam state."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu.models import TransformerLM as JTransformerLM

    kw = dict(num_labels=V, max_length=T, d_model=16, n_heads=n_heads,
              n_blocks=1, seed=seed)
    jnet = JTransformerLM(**kw).init()
    weights = jax.tree_util.tree_map(np.asarray, jnet.params)

    def make():
        net = params_from_jax(weights, TransformerLM(**kw).init(
            device="cpu"))
        net.updater_state = net.conf.updater.init(net.params)
        return net

    return jnet, make


def jspec(spec):
    return tuple(spec)


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("model_size", [2, 3, 4])
def test_specs_equal_jax(model_size):
    """Kernels and biases shard on the last axis where it divides (8 % 3
    stays replicated), as JAX's ``network_param_specs``."""
    jnet, tnet = cnn_pair()
    want = jms.network_param_specs(jnet, model_size=model_size)
    got = network_param_specs(tnet, model_size=model_size)
    assert {k: {n: tuple(s) for n, s in v.items()} for k, v in got.items()} \
        == {k: {n: jspec(s) for n, s in v.items()} for k, v in want.items()}
    if model_size == 2:
        assert got["0"]["W"] == P(None, None, None, MODEL_AXIS)
        assert got["0"]["b"] == P(MODEL_AXIS)
        assert got["3"]["W"] == P(None, MODEL_AXIS)
    if model_size == 3:
        assert got["0"]["W"] == P() and got["0"]["b"] == P()


# ---------------------------------------------------------------- parity
def test_dp_tp_matches_single_device_and_jax():
    jnet, ref = cnn_pair()
    _, tp = cnn_pair()
    data = batches()
    for x, y in data:
        ref.do_step(x, y)
        jnet.do_step(x, y)
    trainer = ShardedTrainer(tp, mesh())
    assert tp.params["0"]["W"].sharding.spec == P(None, None, None,
                                                  MODEL_AXIS)
    trainer.fit([DataSet(x, y) for x, y in data])
    assert_trees_close(tp.params, ref.params, rtol=2e-4, atol=2e-5)
    assert_trees_close(tp.params, jnet.params, rtol=2e-4, atol=2e-5)
    out_ref = ref.output(data[0][0]).numpy()
    np.testing.assert_allclose(trainer.output(data[0][0]).numpy(), out_ref,
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(jnet.output(data[0][0])),
                               out_ref, rtol=2e-4, atol=2e-5)
    assert tp.iteration == 3


def test_entries_store_their_share_of_sharded_leaves():
    """Each model entry holds 1/m of a sharded leaf (and of its Adam
    moments); a replicated leaf is whole on every entry."""
    _, net = cnn_pair()
    full = {k: {n: t.numel() for n, t in v.items()}
            for k, v in net.params.items()}
    trainer = ShardedTrainer(net, mesh(2, 2))
    for k, sub in net.params.items():
        for n, st in sub.items():
            sharded = MODEL_AXIS in st.spec
            for piece in st.pieces:
                assert piece.numel() * (2 if sharded else 1) == full[k][n]
    per = trainer.entry_bytes()
    total = sum(4 * n for v in full.values() for n in v.values())
    assert len(per) == 4 and len(set(per)) == 1
    assert per[0] * 2 <= 3 * total * 1.01    # params + m + v, half each


def test_updater_state_sharded_like_params():
    _, net = cnn_pair()
    ShardedTrainer(net, mesh())
    st = net.updater_state["m"]["0"]["W"]
    assert isinstance(st, ShardedTensor)
    assert st.sharding.spec == P(None, None, None, MODEL_AXIS)


def test_batch_not_divisible_raises():
    _, net = cnn_pair()
    trainer = ShardedTrainer(net, mesh())
    bad = DataSet(np.zeros((3, 12, 12, 1), np.float32),
                  np.eye(4, dtype=np.float32)[np.zeros(3, int)])
    with pytest.raises(ValueError, match="not divisible"):
        trainer.fit(bad)


def test_mesh_needs_both_axes_and_a_port_mesh():
    _, net = cnn_pair()
    with pytest.raises(ValueError, match="axes"):
        ShardedTrainer(net, Mesh([CPU] * 2, ("data",)))
    with pytest.raises(TypeError, match="Mesh"):
        ShardedTrainer(net, object())


def test_embedding_vocab_rows_sharded_trains_as_jax():
    def layers(L):
        return [L.EmbeddingLayer(n_in=32, n_out=8, activation="identity"),
                L.OutputLayer(n_in=8, n_out=4, activation="softmax",
                              loss="mcxent")]

    jnet, net = pair(layers, lambda m: m.InputType.feed_forward(1),
                     lambda u: u.Sgd(learning_rate=0.1), seed=3)
    specs = network_param_specs(net, model_size=2)
    assert specs["0"]["W"] == P(MODEL_AXIS, None)
    rs = np.random.RandomState(1)
    x = rs.randint(0, 32, (8, 1)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
    before = net.params["0"]["W"].numpy().copy()
    trainer = ShardedTrainer(net, mesh())
    trainer.fit(DataSet(x, y))
    jtrainer = jms.ShardedTrainer(jnet, jdata_model_mesh(2, 2))
    jtrainer.fit(JDataSet(x, y))
    assert np.isfinite(float(net.score_value))
    assert not np.allclose(before, np.asarray(net.params["0"]["W"]))
    assert_trees_close(net.params, jnet.params, rtol=2e-4, atol=2e-5)


def test_moe_expert_axis_matches_single_device():
    """``tests/test_moe.py::TestExpertParallel``: the expert tensors shard
    on the expert axis, each entry computes its experts, and four
    ``do_step``s after ``shard_network`` equal one device's."""
    def layers(L):
        return [L.MixtureOfExpertsLayer(n_out=16, n_experts=4, top_k=2,
                                        expert_hidden=24),
                L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]

    def build():
        return pair(layers, lambda m: m.InputType.feed_forward(6),
                    lambda u: u.Sgd(learning_rate=0.05))

    rs = np.random.RandomState(6)
    labels = rs.randint(0, 3, 32)
    x = (rs.randn(32, 6) + labels[:, None]).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[labels]
    _, single = build()
    jnet, sharded = build()
    specs = network_param_specs(sharded, 4)
    assert specs["0"]["W1"] == P("model", None, None)
    assert specs["0"]["b1"] == P("model", None)
    assert specs["0"]["Wg"] == P(None, "model")
    shard_network(sharded, data_model_mesh(2, 4, devices=[CPU] * 8))
    assert sharded._sharded.rules["0"].__name__ == "_experts_forward"
    for _ in range(4):
        single.do_step(x, y)
        sharded.do_step(x, y)
        jnet.do_step(x, y)
    np.testing.assert_allclose(sharded.params_flat(), single.params_flat(),
                               atol=1e-5)
    np.testing.assert_allclose(sharded.params_flat(),
                               np.asarray(jnet.params_flat()), atol=1e-5)


@pytest.mark.parametrize("model", [2, 4])
def test_transformer_lm_dp_tp_runs_attention_on_head_shards(monkeypatch,
                                                            model):
    """The zoo ``TransformerLM`` (d_model 16, 4 heads, 1 block): its
    attention and FFN matrices shard over ``model``, the attention core
    sees ``4/m`` heads on every call, and a dp x tp ``fit`` equals the
    unsharded one and JAX's ``ShardedTrainer`` on ``data_model_mesh(2,
    m)`` from the same weights (JAX's rtol 5e-4 / atol 1e-5)."""
    V, T = 8, 8
    rs = np.random.RandomState(2)
    idx = rs.randint(0, V, (4, T + 1))
    x = np.eye(V, dtype=np.float32)[idx[:, :-1]]
    y = np.eye(V, dtype=np.float32)[idx[:, 1:]]
    jnet, make = lm_pair(V, T, n_heads=4, seed=4)
    jms.ShardedTrainer(jnet, jdata_model_mesh(2, model)).fit(
        JDataSet(x, y))

    a = make()
    a.fit(DataSet(x, y))
    heads = []
    orig = fa.flash_attention

    def spy(q, k, v, **kw):
        heads.append(q.shape[1])
        return orig(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    b = make()
    trainer = ShardedTrainer(b, mesh(2, model))
    assert b.params["ff0a"]["W"].sharding.spec == P(None, MODEL_AXIS)
    trainer.fit(DataSet(x, y))
    assert heads and set(heads) == {4 // model}
    # one core call per (data row, model entry, block) and step
    assert len(heads) == 2 * model * b.iteration
    assert np.isfinite(float(b.score_value))
    assert_trees_close(b.params, a.params, rtol=5e-4, atol=1e-5)
    assert_trees_close(b.params, jnet.params, rtol=5e-4, atol=1e-5)


@pytest.mark.slow
def test_vgg16_trains_dp_tp():
    from deeplearning4j_torch.models.zoo import VGG16

    net = VGG16(num_labels=8, input_shape=(32, 32, 3)).init(device="cpu")
    ShardedTrainer(net, mesh(2, 4)).fit(DataSet(
        np.random.RandomState(0).randn(4, 32, 32, 3).astype(np.float32),
        np.eye(8, dtype=np.float32)[[0, 1, 2, 3]]))
    assert net.params["0"]["W"].sharding.spec == P(None, None, None,
                                                   MODEL_AXIS)
    assert np.isfinite(float(net.score_value))


def test_vgg16_specs_shard_every_conv_stack():
    """All VGG16 conv stacks (64..512 channels) divide by 4: every kernel
    is tensor-sharded and takes the column-parallel forward."""
    from deeplearning4j_torch.models.zoo import VGG16

    net = VGG16(num_labels=8, input_shape=(32, 32, 3)).init(device="cpu")
    specs = network_param_specs(net, 4)
    convs = [k for k, layer in zip(map(str, range(len(net.layers))),
                                   net.layers)
             if type(layer).__name__ == "ConvolutionLayer"]
    assert convs and all(specs[k]["W"] == P(None, None, None, MODEL_AXIS)
                         for k in convs)


def test_label_masked_rows_weigh_by_their_mask():
    """A label mask that gives the two data rows different weights: each
    row's masked mean enters by its share of the mask, so the sharded
    step equals one device's and JAX's dp x tp step (the rows are not
    averaged evenly)."""
    V, T = 8, 6
    rs = np.random.RandomState(3)
    idx = rs.randint(0, V, (4, T + 1))
    x = np.eye(V, dtype=np.float32)[idx[:, :-1]]
    y = np.eye(V, dtype=np.float32)[idx[:, 1:]]
    lm = np.ones((4, T), np.float32)
    lm[2:, 2:] = 0.0                       # row 1 keeps 4 of its 12
    jnet, make = lm_pair(V, T, n_heads=2, seed=5)
    jplaced = jms.ShardedTrainer(jnet, jdata_model_mesh(2, 2))._place_ds(
        JDataSet(x, y, labels_mask=lm))

    a, b = make(), make()
    ShardedTrainer(b, mesh(2, 2))
    for _ in range(2):
        la, _ = a.do_step(x, y, None, lm)
        lb, _ = b.do_step(x, y, None, lm)
        lj, _ = jnet.do_step(jplaced.features, jplaced.labels, None,
                             jplaced.labels_mask)
        np.testing.assert_allclose(float(lb), float(lj), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(float(lb), float(la), rtol=2e-4,
                                   atol=2e-5)
    assert_trees_close(b.params, a.params, rtol=2e-4, atol=2e-5)
    assert_trees_close(b.params, jnet.params, rtol=2e-4, atol=2e-5)


def test_sharded_containers_share_one_base():
    """A trainer leaf, a data-parallel batch and a row-sharded table are
    one ``parallel.mesh.ShardedTensor``: the same gather, host view and
    per-piece bytes, whatever the dim they split."""
    from deeplearning4j_torch.nlp.distributed import RowShardedTable
    from deeplearning4j_torch.parallel import mesh as pmesh

    whole = torch.arange(48, dtype=torch.float32).reshape(4, 12)
    m = mesh(2, 2)
    leaf = SpecTensor.place(whole, P(None, MODEL_AXIS), m,
                            _entry_grid(m))
    rep = SpecTensor.place(whole, P(), m, _entry_grid(m))
    batch = pmesh.ShardedArray(list(torch.chunk(whole, 2)),
                               pmesh.DataSharding(Mesh([CPU] * 2,
                                                       ("data",))))
    table = RowShardedTable(list(torch.chunk(whole, 2)))
    for st, piece in ((leaf, 4 * 6 * 4), (rep, 4 * 12 * 4),
                      (batch, 2 * 12 * 4), (table, 2 * 12 * 4)):
        assert isinstance(st, pmesh.ShardedTensor)
        assert pmesh.ShardedTensor is ShardedTensor
        assert st.shape == whole.shape and st.numel() == whole.numel()
        np.testing.assert_array_equal(np.asarray(st), whole.numpy())
        assert torch.equal(st.gather(CPU), whole)
        assert set(st.piece_bytes()) == {piece}
    assert leaf.column(1, 1) is leaf.pieces[3] and len(leaf.parts()) == 2
