"""Port parity: data-parallel training, inference and evaluation on the
devices of one process (``deeplearning4j_torch/parallel/{trainer,
inference,evaluation,early_stopping,model_sharding}.py``,
``FusedEvalDriver(mesh=)``, ``DevicePrefetchIterator(sharding=)``) against
``tests/test_parallel.py``'s JAX reference.

The nets are that file's MLP (6 -> 16 tanh -> 3 softmax) and masked LSTM;
the port's copies take the JAX net's weights. The port's meshes name the
host four times (``Mesh([cpu] * 4, ("data",))``), JAX runs over four of
its eight XLA CPU devices. Tolerances are JAX's own: ``ParallelWrapper``
against one device on the concatenated batch rtol 1e-5 / atol 1e-6 with
SGD and 1e-4 / 1e-5 with Adam, and the same against JAX's
``ParallelWrapper`` from the same weights and batches; inference within
rtol 1e-5 / atol 1e-6 of ``net.output``; evaluation counts exactly equal.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JaxDataSet)
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.earlystopping.config import (  # noqa: E402
    EarlyStoppingConfiguration as JaxESConfig)
from deeplearning4j_tpu.earlystopping.scorecalc import (  # noqa: E402
    DataSetLossCalculator as JaxLossCalculator)
from deeplearning4j_tpu.earlystopping.termination import (  # noqa: E402
    MaxEpochsTerminationCondition as JaxMaxEpochs)
from deeplearning4j_tpu.nn.conf.builders import (  # noqa: E402
    NeuralNetConfiguration as JaxConf)
from deeplearning4j_tpu.nn.conf.layers.core import (  # noqa: E402
    DenseLayer as JaxDense, OutputLayer as JaxOutput)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxMLN)
from deeplearning4j_tpu.nn.updater import (  # noqa: E402
    Adam as JaxAdam, Sgd as JaxSgd)
from deeplearning4j_tpu.parallel import mesh as jmesh  # noqa: E402
from deeplearning4j_tpu.parallel.early_stopping import (  # noqa: E402
    EarlyStoppingParallelTrainer as JaxESParallel)
from deeplearning4j_tpu.parallel.trainer import (  # noqa: E402
    ParallelWrapper as JaxParallelWrapper)
from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.datasets.iterators import (  # noqa: E402
    DevicePrefetchIterator, ListDataSetIterator)
from deeplearning4j_torch.earlystopping.config import (  # noqa: E402
    EarlyStoppingConfiguration)
from deeplearning4j_torch.earlystopping.scorecalc import (  # noqa: E402
    DataSetLossCalculator)
from deeplearning4j_torch.earlystopping.termination import (  # noqa: E402
    MaxEpochsTerminationCondition)
from deeplearning4j_torch.evaluation.classification import (  # noqa: E402
    Evaluation)
from deeplearning4j_torch.evaluation.fused_eval import (  # noqa: E402
    FusedEvalDriver)
from deeplearning4j_torch.nn.conf.builders import (  # noqa: E402
    NeuralNetConfiguration)
from deeplearning4j_torch.nn.conf.layers.core import (  # noqa: E402
    DenseLayer, OutputLayer)
from deeplearning4j_torch.nn.conf.layers.recurrent import (  # noqa: E402
    LSTM, RnnOutputLayer)
from deeplearning4j_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.metrics.registry import (  # noqa: E402
    MetricsRegistry)
from deeplearning4j_torch.nn.updater import Adam, Sgd  # noqa: E402
from deeplearning4j_torch.optimize.listeners import (  # noqa: E402
    TrainingListener)
from deeplearning4j_torch.parallel import (  # noqa: E402
    EarlyStoppingParallelTrainer, ParallelInference, ParallelWrapper,
    evaluate_on_mesh)
from deeplearning4j_torch.parallel.mesh import (  # noqa: E402
    DataSharding, Mesh, ShardedArray, pmean)
from deeplearning4j_torch.parallel.model_sharding import (  # noqa: E402
    data_batch_sharding)
from deeplearning4j_torch.ui.stats import StatsListener  # noqa: E402
from deeplearning4j_torch.ui.storage import (  # noqa: E402
    InMemoryStatsStorage)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

W = 4
CPU = torch.device("cpu")
SGD_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops under several xdist workers: one intra-op thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(n=W):
    return Mesh([CPU] * n, ("data",))


def _conf(builder, dense, output, updater, seed=42):
    return (builder.builder().seed(seed).updater(updater)
            .list(dense(n_in=6, n_out=16, activation="tanh"),
                  output(n_in=16, n_out=3, activation="softmax",
                         loss="mcxent"))
            .build())


def mlps(updater, seed=42):
    """(JAX net, port net) of one MLP: the port takes JAX's weights."""
    jupd = {"Sgd": JaxSgd, "Adam": JaxAdam}[type(updater).__name__](
        learning_rate=updater.learning_rate)
    jnet = JaxMLN(_conf(JaxConf, JaxDense, JaxOutput, jupd, seed)).init()
    tnet = MultiLayerNetwork(_conf(NeuralNetConfiguration, DenseLayer,
                                   OutputLayer, updater, seed)
                             ).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def _make_data(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


def _batches(x, y, B, cls=DataSet):
    return [cls(x[i:i + B], y[i:i + B]) for i in range(0, len(x), B)]


def _assert_params(got, want, **tol):
    for k in want.params:
        for name in want.params[k]:
            np.testing.assert_allclose(
                got.params[k][name].detach().cpu().numpy(),
                np.asarray(want.params[k][name]), err_msg=f"{k}/{name}",
                **tol)


# ---------------------------------------------------------- ParallelWrapper
@pytest.mark.parametrize("mode,updater,freq,tol", [
    ("averaging", Sgd(learning_rate=0.1), 1, SGD_TOL),
    ("shared_gradients", Adam(learning_rate=1e-2), 1, ADAM_TOL),
    ("averaging", Adam(learning_rate=1e-2), 3, ADAM_TOL),
], ids=["averaging_sgd", "shared_gradients_adam", "averaging_f3_adam"])
def test_parallel_wrapper_equals_jax(mode, updater, freq, tol):
    """Both modes, and ``averaging_frequency`` 3 with the updater state
    averaged, against JAX's ``ParallelWrapper`` from the same weights and
    batches (JAX's tolerances)."""
    B, rounds = 4, 2
    x, y = _make_data(W * B * freq * rounds, seed=3)
    jnet, tnet = mlps(updater)
    JaxParallelWrapper(jnet, mesh=jmesh.data_mesh(W), mode=mode,
                       averaging_frequency=freq).fit(
        JaxListIterator(_batches(x, y, B, JaxDataSet), batch_size=B))
    pw = ParallelWrapper(tnet, mesh=cpu_mesh(), mode=mode,
                         averaging_frequency=freq)
    pw.fit(ListDataSetIterator(_batches(x, y, B), batch_size=B))
    _assert_params(tnet, jnet, **tol)
    assert tnet.iteration == jnet.iteration == rounds * freq
    for slot in ("m", "v") if freq > 1 else ():
        for k in jnet.updater_state[slot]:
            for name, a in jnet.updater_state[slot][k].items():
                np.testing.assert_allclose(
                    tnet.updater_state[slot][k][name].numpy(),
                    np.asarray(a), err_msg=f"{slot} {k}/{name}", **tol)
    assert tnet.score_value == pytest.approx(float(jnet.score_value),
                                             rel=1e-4)


@pytest.mark.parametrize("mode,updater,tol", [
    ("averaging", Sgd(learning_rate=0.1), SGD_TOL),
    ("shared_gradients", Adam(learning_rate=1e-2), ADAM_TOL),
], ids=["averaging_sgd", "shared_gradients_adam"])
def test_parallel_wrapper_equals_one_device(mode, updater, tol):
    """W devices with batch B each equal one device on the concatenated
    W·B batch (TestCompareParameterAveragingSparkVsSingleMachine)."""
    B, steps = 4, 5
    x, y = _make_data(W * B * steps)
    _, single = mlps(updater)
    for s in range(steps):
        sl = slice(s * W * B, (s + 1) * W * B)
        single.do_step(x[sl], y[sl])
    _, dist = mlps(updater)
    pw = ParallelWrapper(dist, mesh=cpu_mesh(), mode=mode)
    pw.fit(ListDataSetIterator(_batches(x, y, B), batch_size=B))
    _assert_params(dist, single, **tol)
    assert pw.average_models() is dist


def test_parallel_wrapper_replicas_see_their_own_batches():
    """Round-robin regrouping: worker w trains on batches w, W + w, ...;
    with frequency 2 and SGD, a round equals averaging W two-step
    trajectories run on one device each."""
    B, F = 4, 2
    x, y = _make_data(W * B * F, seed=9)
    batches = _batches(x, y, B)
    _, dist = mlps(Sgd(learning_rate=0.1))
    base = {k: dict(v) for k, v in dist.params.items()}
    finals = []
    for w in range(W):
        _, one = mlps(Sgd(learning_rate=0.1))
        for f in range(F):
            b = batches[f * W + w]
            one.do_step(b.features, b.labels)
        finals.append(one.params)
    ParallelWrapper(dist, mesh=cpu_mesh(), averaging_frequency=F,
                    health_guard=None).fit(batches)
    want = pmean(finals, [CPU] * W)[0]
    for k in want:
        for name in want[k]:
            np.testing.assert_allclose(dist.params[k][name].numpy(),
                                       want[k][name].numpy(), **SGD_TOL)
            assert not torch.equal(dist.params[k][name], base[k][name])


def test_mid_stream_batch_mismatch_warns_and_counts():
    """A mid-stream minibatch of odd size is dropped with JAX's warning
    and counted; a genuine trailing partial is skipped silently."""
    x, y = _make_data(8 * 4)
    batches = _batches(x, y, 4)
    odd = DataSet(x[:2], y[:2])
    _, net = mlps(Sgd(learning_rate=0.1))
    pw = ParallelWrapper(net, mesh=cpu_mesh(), averaging_frequency=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pw.fit(batches[:4] + [odd] + batches[4:], epochs=1)
    assert pw.dropped_batches == 1
    assert any("mid-stream" in str(w.message) for w in caught)
    assert net.iteration == 2
    _, net2 = mlps(Sgd(learning_rate=0.1))
    pw2 = ParallelWrapper(net2, mesh=cpu_mesh(), averaging_frequency=1)
    with warnings.catch_warnings(record=True) as caught2:
        warnings.simplefilter("always")
        pw2.fit(batches + [odd] + batches[:3], epochs=1)
    assert pw2.dropped_batches == 1          # not trailing: counted
    with warnings.catch_warnings(record=True) as caught3:
        warnings.simplefilter("always")
        pw2.fit(batches + [odd], epochs=1)
    assert pw2.dropped_batches == 1          # trailing partial: silent
    assert not any("mid-stream" in str(w.message) for w in caught3)
    assert len(caught2) >= 1


class _Timings(TrainingListener):
    def __init__(self):
        self.seen = []

    def on_phase_timings(self, model, timings):
        self.seen.append(timings)


def test_phase_timings_reach_listeners_and_stats_listener():
    """Each round reports its phase wall times to listeners that override
    ``on_phase_timings``, and ``StatsListener`` carries them on its next
    update record."""
    x, y = _make_data(W * 4 * 3, seed=4)
    _, net = mlps(Sgd(learning_rate=0.1))
    storage = InMemoryStatsStorage()
    # a registry of its own: the shared one is compared against JAX's
    # elsewhere (tests/test_torch_server.py)
    stats = StatsListener(storage, reporting_frequency=1,
                          registry=MetricsRegistry())
    mine = _Timings()
    net.set_listeners(stats, mine) if hasattr(net, "set_listeners") \
        else setattr(net, "listeners", [stats, mine])
    pw = ParallelWrapper(net, mesh=cpu_mesh(), report_score=False)
    pw.fit(_batches(x, y, 4))
    assert len(mine.seen) == 3
    t = pw.last_phase_timings
    assert set(t) == {"host_prep_ms", "device_round_ms", "averaging",
                      "round_iterations", "workers"}
    assert t["workers"] == W and t["round_iterations"] == 1
    updates = storage.get_all_updates_after(stats.session_id,
                                            "StatsListener")
    assert updates and all("phase_timings" in u["data"] for u in updates)


def test_health_guard_skips_a_nan_round_on_every_replica():
    """A NaN batch on one worker under SHARED_GRADIENTS poisons the mean
    gradient: every replica skips that step, and the params stay finite
    and equal to a run without the bad round's update."""
    x, y = _make_data(W * 4 * 2, seed=6)
    bad = x.copy()
    bad[4 * W + 1] = np.nan                  # round 2, worker 0
    _, net = mlps(Adam(learning_rate=1e-2))
    _, ref = mlps(Adam(learning_rate=1e-2))
    ParallelWrapper(ref, mesh=cpu_mesh(), mode="shared_gradients").fit(
        _batches(x[:W * 4], y[:W * 4], 4))
    ParallelWrapper(net, mesh=cpu_mesh(), mode="shared_gradients").fit(
        _batches(bad, y, 4))
    for k in ref.params:
        for name in ref.params[k]:
            assert torch.equal(net.params[k][name], ref.params[k][name])
    assert net.iteration == 2


# ------------------------------------------------------ early stopping
def test_early_stopping_parallel_equals_jax():
    """``EarlyStoppingParallelTrainer`` over 4 workers: the same epochs,
    scores (rtol 1e-5) and final weights (JAX's Adam tolerance) as JAX's
    trainer from the same weights."""
    x, y = _make_data(16 * 4, seed=5)
    xv, yv = _make_data(32, seed=6)
    jnet, tnet = mlps(Adam(learning_rate=0.05))
    jres = JaxESParallel(
        JaxESConfig(epoch_termination_conditions=[JaxMaxEpochs(3)],
                    score_calculator=JaxLossCalculator(JaxListIterator(
                        _batches(xv, yv, 8, JaxDataSet), batch_size=8))),
        jnet, JaxListIterator(_batches(x, y, 4, JaxDataSet), batch_size=4),
        mesh=jmesh.data_mesh(W)).fit()
    tres = EarlyStoppingParallelTrainer(
        EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(3)],
            score_calculator=DataSetLossCalculator(ListDataSetIterator(
                _batches(xv, yv, 8), batch_size=8))),
        tnet, ListDataSetIterator(_batches(x, y, 4), batch_size=4),
        mesh=cpu_mesh()).fit()
    assert tres.total_epochs == jres.total_epochs == 3
    assert tres.best_model_epoch == jres.best_model_epoch
    assert sorted(tres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        assert tres.score_vs_epoch[e] == pytest.approx(s, rel=1e-5)
    _assert_params(tnet, jnet, **ADAM_TOL)


# ------------------------------------------------------------- inference
def test_parallel_inference_matches_output():
    """21 rows (not a worker multiple) over 4 devices: rows within 1e-5 of
    the port's and JAX's ``net.output``; ``submit`` coalesces through the
    same split forward."""
    jnet, net = mlps(Sgd(learning_rate=0.1))
    x, _ = _make_data(21, seed=11)
    with ParallelInference(net, mesh=cpu_mesh()) as inf:
        assert inf.workers == W
        out = inf.output(x)
        fut = inf.submit(x[:5])
        np.testing.assert_allclose(fut.result(timeout=60), out[:5],
                                   **SGD_TOL)
    np.testing.assert_allclose(out, net.output(x).numpy(), **SGD_TOL)
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), **SGD_TOL)


def test_parallel_inference_rnn_with_mask():
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater(Sgd(learning_rate=0.1))
            .list(LSTM(n_in=4, n_out=6),
                  RnnOutputLayer(n_in=6, n_out=2, activation="softmax",
                                 loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rs = np.random.RandomState(2)
    x = rs.randn(10, 5, 4).astype(np.float32)
    mask = (rs.rand(10, 5) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    with ParallelInference(net, mesh=cpu_mesh()) as inf:
        np.testing.assert_allclose(inf.output(x, mask=mask),
                                   net.output(x, mask=mask).numpy(),
                                   **SGD_TOL)


# ------------------------------------------------------------ evaluation
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_batch"])
def test_evaluate_on_mesh_counts_equal_evaluate(fused):
    """Mesh evaluation (the devices' counts merged) equals the one-device
    evaluation: the same confusion matrix, accuracy and F1; a ragged last
    batch is padded to a worker multiple with zero weights."""
    _, net = mlps(Sgd(learning_rate=0.1))
    x, y = _make_data(70, seed=13)
    batches = _batches(x, y, 16)                 # the last holds 6 rows
    net.fit(ListDataSetIterator(batches, batch_size=16), epochs=2)
    ev_seq = net.evaluate(ListDataSetIterator(batches, batch_size=16))
    ev_par = evaluate_on_mesh(net, ListDataSetIterator(batches,
                                                       batch_size=16),
                              mesh=cpu_mesh(), fused=fused)
    np.testing.assert_array_equal(ev_par.confusion, ev_seq.confusion)
    assert ev_par.accuracy() == pytest.approx(ev_seq.accuracy())
    assert ev_par.f1() == pytest.approx(ev_seq.f1())


def test_fused_eval_driver_rounds_the_bucket_to_the_mesh():
    """``FusedEvalDriver(mesh=)`` pads a 6-row bucket to 8 over 4 devices
    and keeps one accumulator a device; top-N counts equal one device's."""
    _, net = mlps(Sgd(learning_rate=0.1))
    x, y = _make_data(18, seed=2)
    batches = _batches(x, y, 6)
    one = FusedEvalDriver(net).evaluate(batches, Evaluation(top_n=2))
    drv = FusedEvalDriver(net, mesh=cpu_mesh())
    assert drv._row_multiple == W
    blocks = [p for tag, p in drv._blocks(batches) if tag == "block"]
    assert blocks and blocks[0][0].shape[1] == 8
    par = drv.evaluate(batches, Evaluation(top_n=2))
    np.testing.assert_array_equal(par.confusion, one.confusion)
    assert (par.top_n_correct, par.top_n_total) == \
        (one.top_n_correct, one.top_n_total) == (par.top_n_correct, 18)


# ------------------------------------------------------ sharded placement
def test_sharded_prefetch_places_one_piece_per_device():
    """``DevicePrefetchIterator(sharding=data_batch_sharding(mesh))``
    hands out each array as one piece per mesh device, equal to the
    batch; a net trains on the placed batches as on the host ones."""
    mesh = cpu_mesh()
    sh = data_batch_sharding(mesh, np.zeros((8, 6)))
    assert sh == DataSharding(mesh) and sh.device_set == {CPU}
    x, y = _make_data(16, seed=8)
    placed = list(DevicePrefetchIterator(_batches(x, y, 8), depth=2,
                                         sharding=sh))
    assert len(placed) == 2
    for ds, (lo, hi) in zip(placed, ((0, 8), (8, 16))):
        assert isinstance(ds.features, ShardedArray)
        assert [tuple(p.shape) for p in ds.features.pieces] == [(2, 6)] * W
        np.testing.assert_array_equal(np.asarray(ds.features), x[lo:hi])
        np.testing.assert_array_equal(ds.labels.gather(CPU).numpy(),
                                      y[lo:hi])
    _, a = mlps(Sgd(learning_rate=0.1))
    _, b = mlps(Sgd(learning_rate=0.1))
    for ds in placed:
        a.fit(ds)
    for ds in _batches(x, y, 8):
        b.fit(ds)
    for k in a.params:
        for name in a.params[k]:
            assert torch.equal(a.params[k][name], b.params[k][name])


def test_partial_batch_with_sharding_raises_clearly():
    x, y = _make_data(18)
    it = DevicePrefetchIterator(_batches(x, y, 8), depth=2,
                                sharding=DataSharding(cpu_mesh()))
    with pytest.raises(ValueError, match="trailing partial batch"):
        list(it)
