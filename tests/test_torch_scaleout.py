"""Port parity: the scale-out facades (the port's
``parallel/{spark,parameter_server}.py`` and ``nlp/distributed.py``)
against the JAX package's on the CPU — the counterpart of
``tests/test_scaleout.py``'s ``TestSparkFacade`` and
``TestParameterServer``, the parameter server's wire between the two
packages, and sharded embedding tables.

Meshes name the CPU eight times; JAX's run over its XLA CPU devices. Both
packages start from the same weights (``params_from_jax``). Tolerances:
parameter averaging equals one machine at JAX's atol 1e-10 (f64), and
JAX's facade at 1e-10; the parameter server's sparse wire bytes are
JAX's exactly; a Word2Vec fit over sharded tables equals the unsharded
fit within atol 1e-6 (bitwise here: the CPU adds in index order; allclose
because CUDA's ``index_add_`` adds with atomics, ROADMAP C5).
"""

import threading
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet)
from deeplearning4j_tpu.nlp import distributed as jdist  # noqa: E402
from deeplearning4j_tpu.nn import updater as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import builders as jb  # noqa: E402
from deeplearning4j_tpu.nn.conf import inputs as jin  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.parallel import parameter_server as jps  # noqa
from deeplearning4j_tpu.parallel import spark as jspark  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import (  # noqa: E402
    data_model_mesh as jdata_model_mesh)
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator)
from deeplearning4j_torch.nlp.distributed import (  # noqa: E402
    RowShardedTable, shard_embedding_tables, sharded_vocab_rows)
from deeplearning4j_torch.nlp.word2vec import Word2Vec  # noqa: E402
from deeplearning4j_torch.nn import updater as tupd  # noqa: E402
from deeplearning4j_torch.nn.conf import builders as tb  # noqa: E402
from deeplearning4j_torch.nn.conf import inputs as tin  # noqa: E402
from deeplearning4j_torch.nn.conf import layers as tl  # noqa: E402
from deeplearning4j_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TMLN)
from deeplearning4j_torch.parallel.mesh import Mesh  # noqa: E402
from deeplearning4j_torch.parallel.parameter_server import (  # noqa: E402
    ParameterServer, ParameterServerClient, ParameterServerParallelWrapper,
    ParameterServerTrainer, _pack_sparse, _unpack_sparse)
from deeplearning4j_torch.parallel.spark import (  # noqa: E402
    REPARTITION_NEVER, ParameterAveragingTrainingMaster,
    SparkComputationGraph, SparkDl4jMultiLayer, repartition_datasets)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def host_mesh(n=8, axis="data"):
    return Mesh([CPU] * n, (axis,))


def pair(seed=12345, lr=0.1, dtype="float64"):
    """``tests/test_scaleout.py::_net`` in both packages, same weights."""
    def conf(b, L, inp, upd):
        return (b.NeuralNetConfiguration.builder().seed(seed)
                .updater(upd.Sgd(learning_rate=lr)).dtype(dtype)
                .list(L.DenseLayer(n_out=10, activation="tanh"),
                      L.OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
                .set_input_type(inp.InputType.feed_forward(4)).build())

    jnet = JMLN(conf(jb, jl, jin, jupd)).init()
    tnet = TMLN(conf(tb, tl, tin, tupd)).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def arrays(n_batches=16, batch=4, seed=0, dtype=np.float64):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        labels = rs.randint(0, 3, batch)
        x = (rs.randn(batch, 4) + labels[:, None]).astype(dtype)
        out.append((x, np.eye(3, dtype=dtype)[labels]))
    return out


def tsets(arr):
    return [DataSet(x, y) for x, y in arr]


def jsets(arr):
    return [JDataSet(x, y) for x, y in arr]


# ----------------------------------------------------------- Spark facade
def test_repartition_balances_ragged_batches_as_jax():
    rs = np.random.RandomState(1)
    ragged = [(rs.randn(n, 4).astype(np.float32),
               np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])
              for n in (7, 3, 9, 5)]
    out = repartition_datasets(tsets(ragged), batch_size=6)
    want = jspark.repartition_datasets(jsets(ragged), batch_size=6)
    assert [d.features.shape[0] for d in out] == [6, 6, 6, 6]
    for a, b in zip(out, want):
        np.testing.assert_array_equal(np.asarray(a.features),
                                      np.asarray(b.features))
    uniform = tsets(arrays(4, 4))
    assert repartition_datasets(uniform, 6) is not uniform
    assert [d.features.shape[0]
            for d in repartition_datasets(uniform, 6)] == [4, 4, 4, 4]
    assert [d.features.shape[0] for d in repartition_datasets(
        tsets(ragged), 6, REPARTITION_NEVER)] == [7, 3, 9, 5]
    with pytest.raises(ValueError, match="repartition"):
        ParameterAveragingTrainingMaster(repartition="sometimes",
                                         mesh=host_mesh())


def test_ragged_batches_train_without_drops():
    rs = np.random.RandomState(2)
    ragged = [DataSet((rs.randn(n, 4) + 1).astype(np.float64),
                      np.eye(3)[rs.randint(0, 3, n)])
              for n in (13, 7, 9, 3)]  # 32 examples
    _, net = pair()
    master = ParameterAveragingTrainingMaster(batch_size_per_worker=4,
                                              mesh=host_mesh())
    SparkDl4jMultiLayer(net, master).fit(ragged)
    assert net.iteration > 0


def test_aggregation_depth_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ParameterAveragingTrainingMaster(aggregation_depth=4,
                                         mesh=host_mesh())
    assert any("aggregation_depth" in str(x.message) for x in w)


def test_param_averaging_equals_single_machine_and_jax():
    """averaging_frequency=1 over 8 workers == one device on the
    concatenated worker batches (TestCompareParameterAveragingSparkVs
    SingleMachine), and == JAX's facade."""
    data = arrays(16, 4)
    jnet, spark_net = pair()
    master = ParameterAveragingTrainingMaster(averaging_frequency=1,
                                              mesh=host_mesh())
    SparkDl4jMultiLayer(spark_net, master).fit(tsets(data))
    _, single = pair()
    for r in range(2):
        group = tsets(data[r * 8:(r + 1) * 8])
        merged = DataSet.merge(group)
        single.do_step(merged.features, merged.labels)
    np.testing.assert_allclose(spark_net.params_flat(), single.params_flat(),
                               atol=1e-10)
    jmaster = jspark.ParameterAveragingTrainingMaster(averaging_frequency=1,
                                                      workers=8)
    jspark.SparkDl4jMultiLayer(jnet, jmaster).fit(jsets(data))
    np.testing.assert_allclose(spark_net.params_flat(),
                               np.asarray(jnet.params_flat()), atol=1e-10)


def test_facade_distributed_evaluate_and_graph_facade():
    _, net = pair(dtype="float32")
    data = tsets(arrays(8, 8, dtype=np.float32))
    facade = SparkDl4jMultiLayer(
        net, ParameterAveragingTrainingMaster(mesh=host_mesh()))
    facade.fit(data, epochs=20)
    ev = facade.evaluate(ListDataSetIterator(data, batch_size=8))
    assert ev.accuracy() > 0.5
    assert facade.get_network() is net
    assert issubclass(SparkComputationGraph, SparkDl4jMultiLayer)


# -------------------------------------------------------- parameter server
def test_push_pull_averaging():
    ps = ParameterServer(np.zeros(4, np.float32), alpha=0.5)
    c = ParameterServerClient(server=ps)
    c.push(np.ones(4, np.float32))
    assert np.allclose(c.pull(), 0.5)
    c.push(np.ones(4, np.float32))
    assert np.allclose(c.pull(), 0.75)
    with pytest.raises(ValueError, match="exactly one"):
        ParameterServerClient()


def test_http_transport_roundtrip():
    ps = ParameterServer(np.arange(6, dtype=np.float32))
    port = ps.serve()
    try:
        c = ParameterServerClient(address=f"http://127.0.0.1:{port}")
        assert np.allclose(c.pull(), np.arange(6))
        c.push(np.arange(6, dtype=np.float32) * 3)
        assert np.allclose(c.pull(), np.arange(6) * 2.0)  # alpha=0.5 avg
    finally:
        ps.stop()


def test_async_wrapper_trains():
    _, net = pair(dtype="float32", lr=0.05)
    data = tsets(arrays(12, 8, seed=3, dtype=np.float32))
    merged = DataSet.merge(data)
    s0 = net.score(merged)
    wrapper = ParameterServerParallelWrapper(net, workers=3, alpha=0.5)
    wrapper.fit(data, epochs=6)
    assert net.score(merged) < s0 * 0.8
    assert wrapper.server.pushes == 12 * 6


def test_compressed_delta_wrapper_converges():
    _, net = pair(dtype="float32", lr=0.05)
    data = tsets(arrays(12, 8, seed=4, dtype=np.float32))
    merged = DataSet.merge(data)
    s0 = net.score(merged)
    wrapper = ParameterServerParallelWrapper(net, workers=3, compress=True,
                                             threshold=2e-2)
    wrapper.fit(data, epochs=6)
    assert net.score(merged) < s0 * 0.8, "compressed PS did not converge"
    dens = [d for t in wrapper.trainers for d in t.message_density]
    assert dens and all(0.0 <= d <= 1.0 for d in dens)
    assert np.mean(dens) < 0.5, f"messages not sparse: {np.mean(dens)}"


def test_sparse_delta_http_roundtrip():
    ps = ParameterServer(np.zeros(8, np.float32))
    port = ps.serve()
    try:
        c = ParameterServerClient(address=f"http://127.0.0.1:{port}")
        c.push_sparse_delta(np.array([1, 5], np.int32),
                            np.array([True, False]), 0.25, 8)
        expect = np.zeros(8, np.float32)
        expect[1], expect[5] = 0.25, -0.25
        assert np.allclose(c.pull(), expect)
    finally:
        ps.stop()


def test_error_feedback_accumulates_small_deltas():
    ps = ParameterServer(np.zeros(4, np.float32), alpha=1.0)

    class TinyNet:
        """Each fit moves the params by +3e-4."""

        def __init__(self):
            self.flat = np.zeros(4, np.float32)

        def set_params_flat(self, f):
            self.flat = np.asarray(f, np.float32).copy()

        def params_flat(self):
            return self.flat

        def fit(self, ds):
            self.flat = self.flat + 3e-4

    t = ParameterServerTrainer(TinyNet(), ParameterServerClient(ps),
                               compress=True, threshold=1e-3)
    for _ in range(3):
        t.fit(None)
    assert np.allclose(ps.pull(), 0.0)        # 9e-4: under threshold
    t.fit(None)                               # 1.2e-3 crosses
    assert np.allclose(ps.pull(), 1e-3)


def test_sparse_wire_bytes_equal_jax_and_servers_interoperate():
    """The packed delta is JAX's byte for byte; a port client drives the
    JAX server over HTTP and a JAX client the port's."""
    rs = np.random.RandomState(5)
    idx = np.sort(rs.choice(100, 17, replace=False)).astype(np.int32)
    signs = rs.rand(17) > 0.5
    raw = _pack_sparse(idx, signs, 0.125, 100)
    assert raw == jps._pack_sparse(idx, signs, 0.125, 100)
    for a, b in zip(_unpack_sparse(raw), jps._unpack_sparse(raw)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    start = np.linspace(-1, 1, 100).astype(np.float32)
    for server, client in ((jps.ParameterServer, ParameterServerClient),
                           (ParameterServer, jps.ParameterServerClient)):
        ps = server(start, alpha=0.5)
        port = ps.serve()
        try:
            c = client(address=f"http://127.0.0.1:{port}")
            c.push_sparse_delta(idx, signs, 0.125, 100)
            want = start.copy()
            want[idx] += np.where(signs, 0.125, -0.125)
            np.testing.assert_array_equal(c.pull(), want)
            c.push(np.zeros(100, np.float32))
            np.testing.assert_array_equal(c.pull(), want * 0.5)
        finally:
            ps.stop()


def test_server_takes_concurrent_pushes():
    ps = ParameterServer(np.zeros(16, np.float32), alpha=1.0)
    c = ParameterServerClient(server=ps)

    def push(i):
        for _ in range(25):
            c.push_sparse_delta(np.array([i], np.int32), np.array([True]),
                                1.0, 16)

    threads = [threading.Thread(target=push, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert ps.pushes == 200
    np.testing.assert_array_equal(ps.pull()[:8], np.full(8, 25.0))


# ---------------------------------------------------- sharded embeddings
SENTENCES = [" ".join(np.random.RandomState(i).choice(
    [f"w{j}" for j in range(37)], 12)) for i in range(60)]


@pytest.mark.parametrize("kw", [
    dict(negative=5, use_hierarchic_softmax=False),
    dict(negative=0),
    dict(negative=3, elements_algorithm="cbow", batch_size=64),
], ids=["skipgram-ns", "skipgram-hs", "cbow-ns"])
def test_sharded_tables_fit_equals_unsharded(kw):
    def make():
        w = Word2Vec(layer_size=16, window=3, seed=3, epochs=2,
                     backend="device", device="cpu", **kw)
        w.build_vocab(SENTENCES)
        w.reset_weights()
        return w

    plain, sharded = make(), make()
    plain.fit(SENTENCES)
    shard_embedding_tables(sharded, host_mesh(2, "model"))
    assert isinstance(sharded.syn0, RowShardedTable)
    sharded.fit(SENTENCES)
    assert isinstance(sharded.syn0, RowShardedTable)   # stays sharded
    V = plain.syn0.shape[0]
    for name in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_allclose(
            np.asarray(getattr(sharded, name))[:V],
            getattr(plain, name).numpy(), atol=1e-6, err_msg=name)
    assert abs(sharded.similarity("w1", "w2")
               - plain.similarity("w1", "w2")) < 1e-5


def test_segment_sums_add_only_updated_rows_on_sharded_tables():
    """The segment path (``segment_updates=True``) adds each batch's
    summed rows on their owners: row-sharded tables (two entries,
    syn1neg padded) end equal to plain ones and to the stacked-table add, and a
    block no update touches is left bitwise as it was."""
    from deeplearning4j_torch.nlp import learning as tlearn

    rs = np.random.RandomState(4)
    V, V1, Vn, D, M = 12, 10, 11, 6, 200
    plain = [torch.tensor(rs.randn(n, D).astype(np.float32))
             for n in (V, V1, Vn)]
    idx = rs.randint(0, V + V1 + Vn, M)
    idx[idx < V] %= 5                    # syn0's second block: no update
    parts = [(torch.tensor(idx), torch.tensor(rs.randn(M, D).astype(
        np.float32)), torch.tensor((rs.rand(M) > 0.2).astype(np.float32)),
              torch.full((M,), 4.0))]
    want = tlearn._segment_row_add(*parts[0], torch.cat(plain))
    sharded = [RowShardedTable(list(torch.chunk(torch.cat(
        [t, t.new_zeros((n % 2, D))]), 2))) for t, n in
        zip(plain, (V, V1, Vn))]
    untouched = sharded[0].blocks[1].clone()
    tlearn._apply_segments(*sharded, parts)
    tlearn._apply_segments(*plain, parts)
    np.testing.assert_array_equal(sharded[0].blocks[1].numpy(),
                                  untouched.numpy())
    for got, ref, lo, n in zip(sharded, plain, (0, V, V + V1),
                               (V, V1, Vn)):
        np.testing.assert_array_equal(np.asarray(got)[:n], ref.numpy())
        np.testing.assert_array_equal(ref.numpy(), want[lo:lo + n].numpy())


def test_sharded_rows_pad_to_the_model_axis_as_jax():
    w = Word2Vec(layer_size=8, negative=2, use_hierarchic_softmax=False,
                 backend="device", device="cpu")
    w.build_vocab(SENTENCES)
    w.reset_weights()
    mesh = Mesh(np.array([CPU] * 6, dtype=object).reshape(2, 3),
                ("data", "model"))
    V = w.vocab.num_words()
    assert sharded_vocab_rows(V, mesh) == jdist.sharded_vocab_rows(
        V, jdata_model_mesh(2, 3))
    before = w.syn0.clone()
    shard_embedding_tables(w, mesh)
    assert w.syn0.shape[0] == sharded_vocab_rows(V, mesh) == 39
    assert [b.shape[0] for b in w.syn0.blocks] == [13] * 3
    np.testing.assert_array_equal(np.asarray(w.syn0)[:V], before.numpy())
    assert not np.asarray(w.syn0)[V:].any()
    idx = torch.tensor([[0, 14], [38, 13]])
    np.testing.assert_array_equal(w.syn0[idx].numpy(),
                                  np.asarray(w.syn0)[idx.numpy()])
    with pytest.raises(ValueError, match="model"):
        shard_embedding_tables(w, host_mesh(2))
