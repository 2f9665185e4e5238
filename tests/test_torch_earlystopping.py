"""The port's ``earlystopping/`` on the CPU: the seven cases of
``tests/test_earlystopping.py`` as the JAX package writes them, over the
port's nets (``device="cpu"``), the max-epochs run also held to JAX's on
the same weights (the score per epoch within rtol 1e-4, the best epoch
and the termination equal); and one case on an LSTM graph (LSTM ->
LastTimeStepVertex -> OutputLayer over masked sequences of ragged
length), held to JAX's the same way.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_torch.earlystopping import (
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    InvalidScoreIterationTerminationCondition,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_torch.earlystopping.config import TerminationReason
from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.core import DenseLayer, OutputLayer
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.nn.updater import Adam, Sgd
from deeplearning4j_torch.utils.convert import params_from_jax

pytestmark = pytest.mark.torch_port


def _conf(lr=0.01, updater=None):
    return (NeuralNetConfiguration.builder()
            .seed(12345)
            .updater(updater or Adam(learning_rate=lr))
            .list(DenseLayer(n_out=16, activation="relu"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())


def _net(lr=0.01, updater=None):
    return MultiLayerNetwork(_conf(lr, updater)).init(device="cpu")


def _iris_like(n=60, seed=0):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 3, n)
    x = (rs.randn(n, 4) + labels[:, None] * 2.0).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[labels]
    return x, y


def _iris_like_iterator(n=60, batch=20, seed=0):
    ds = DataSet(*_iris_like(n, seed))
    return ListDataSetIterator(list(ds.batch_by(batch)), batch_size=batch)


def _jax_iterator(n=60, batch=20, seed=0):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import (
        ListDataSetIterator as JList)

    ds = JDataSet(*_iris_like(n, seed))
    return JList(list(ds.batch_by(batch)), batch_size=batch)


def _jax_es():
    import deeplearning4j_tpu.earlystopping as jes

    return jes


def _assert_runs_agree(res, jres):
    assert res.termination_reason == jres.termination_reason
    assert res.termination_details == jres.termination_details
    assert res.best_model_epoch == jres.best_model_epoch
    assert res.total_epochs == jres.total_epochs
    assert sorted(res.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        assert res.score_vs_epoch[e] == pytest.approx(s, rel=1e-4), e
    assert res.best_model_score == pytest.approx(jres.best_model_score,
                                                 rel=1e-4)


class TestEarlyStopping:
    def test_max_epochs_termination(self):
        net = _net()
        it = _iris_like_iterator()
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(5)],
            score_calculator=DataSetLossCalculator(
                _iris_like_iterator(seed=1)),
            model_saver=InMemoryModelSaver())
        result = EarlyStoppingTrainer(cfg, net, it).fit()
        assert result.termination_reason == \
            TerminationReason.EPOCH_TERMINATION_CONDITION
        assert result.total_epochs == 5
        assert result.best_model is not None
        assert len(result.score_vs_epoch) == 5
        best = result.best_model
        calc = DataSetLossCalculator(_iris_like_iterator(seed=1))
        assert calc.calculate_score(best) == pytest.approx(
            result.best_model_score, rel=1e-5)

    def test_max_epochs_run_matches_jax(self):
        """The same run on the JAX net's weights: scores per epoch, best
        epoch and termination as JAX's."""
        from deeplearning4j_tpu.nn.conf.builders import (
            NeuralNetConfiguration as JNNC)
        from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
        from deeplearning4j_tpu.nn.conf.layers.core import (
            DenseLayer as JDense, OutputLayer as JOut)
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JM
        from deeplearning4j_tpu.nn.updater import Adam as JAdam

        jes = _jax_es()
        jconf = (JNNC.builder().seed(12345)
                 .updater(JAdam(learning_rate=0.01))
                 .list(JDense(n_out=16, activation="relu"),
                       JOut(n_out=3, activation="softmax", loss="mcxent"))
                 .set_input_type(JIT.feed_forward(4)).build())
        jnet = JM(jconf).init()
        net = _net()
        params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax.device_get(jnet.params)), net)
        jres = jes.EarlyStoppingTrainer(jes.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                jes.MaxEpochsTerminationCondition(5)],
            score_calculator=jes.DataSetLossCalculator(
                _jax_iterator(seed=1))), jnet, _jax_iterator()).fit()
        res = EarlyStoppingTrainer(EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(5)],
            score_calculator=DataSetLossCalculator(
                _iris_like_iterator(seed=1))), net,
            _iris_like_iterator()).fit()
        _assert_runs_agree(res, jres)
        assert res.best_model.device.type == "cpu"

    def test_score_improvement_termination(self):
        """Training with LR=0 can't improve -> stops after patience runs
        out."""
        net = _net(updater=Sgd(learning_rate=0.0))
        it = _iris_like_iterator()
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                ScoreImprovementEpochTerminationCondition(2),
                MaxEpochsTerminationCondition(50)],
            score_calculator=DataSetLossCalculator(
                _iris_like_iterator(seed=1)))
        result = EarlyStoppingTrainer(cfg, net, it).fit()
        assert result.termination_reason == \
            TerminationReason.EPOCH_TERMINATION_CONDITION
        assert "ScoreImprovement" in result.termination_details
        assert result.total_epochs <= 5

    def test_max_score_iteration_termination(self):
        """Huge LR diverges -> MaxScoreIterationTerminationCondition
        fires."""
        net = _net(updater=Sgd(learning_rate=1e4))
        it = _iris_like_iterator()
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(100)],
            iteration_termination_conditions=[
                MaxScoreIterationTerminationCondition(50.0),
                InvalidScoreIterationTerminationCondition()],
            score_calculator=DataSetLossCalculator(
                _iris_like_iterator(seed=1)))
        result = EarlyStoppingTrainer(cfg, net, it).fit()
        assert result.termination_reason == \
            TerminationReason.ITERATION_TERMINATION_CONDITION

    def test_max_time_termination(self):
        net = _net()
        it = _iris_like_iterator()
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                MaxEpochsTerminationCondition(10000)],
            iteration_termination_conditions=[
                MaxTimeIterationTerminationCondition(0.0)],
            score_calculator=DataSetLossCalculator(
                _iris_like_iterator(seed=1)))
        result = EarlyStoppingTrainer(cfg, net, it).fit()
        assert result.termination_reason == \
            TerminationReason.ITERATION_TERMINATION_CONDITION
        assert "MaxTime" in result.termination_details

    def test_max_time_ignores_wall_clock_jump(self, monkeypatch):
        """The time budget is measured on the monotonic clock, so a
        wall-clock jump must not fire termination early."""
        import time as _time

        cond = MaxTimeIterationTerminationCondition(3600.0)
        cond.initialize()
        real_time = _time.time
        monkeypatch.setattr(_time, "time", lambda: real_time() + 7200.0)
        assert not cond.terminate(0.0)
        tiny = MaxTimeIterationTerminationCondition(0.0)
        tiny.initialize()
        assert tiny.terminate(0.0)

    def test_local_file_saver_roundtrip(self, tmp_path):
        net = _net()
        it = _iris_like_iterator()
        saver = LocalFileModelSaver(str(tmp_path), device="cpu")
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(3)],
            score_calculator=DataSetLossCalculator(
                _iris_like_iterator(seed=1)),
            model_saver=saver, save_last_model=True)
        result = EarlyStoppingTrainer(cfg, net, it).fit()
        assert (tmp_path / "bestModel.bin").exists()
        assert (tmp_path / "latestModel.bin").exists()
        best = saver.get_best_model()
        x = np.random.RandomState(5).randn(4, 4).astype(np.float32)
        assert best.output(x).shape == (4, 3)
        assert result.best_model_epoch >= 0
        assert result.best_model_epoch in result.score_vs_epoch
        # the zips are the JAX package's
        from deeplearning4j_tpu.utils.model_serializer import load_model

        jbest = load_model(str(tmp_path / "bestModel.bin"))
        np.testing.assert_array_equal(np.asarray(jbest.params_flat()),
                                      best.params_flat())

    def test_early_stopping_graph(self):
        """Same loop drives a ComputationGraph."""
        from deeplearning4j_torch.nn.graph import ComputationGraph

        conf = (NeuralNetConfiguration.builder()
                .seed(1).updater(Adam(learning_rate=0.01))
                .graph_builder()
                .add_inputs("in")
                .add_layer("d", DenseLayer(n_out=16, activation="relu"), "in")
                .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "d")
                .set_outputs("out")
                .set_input_types(InputType.feed_forward(4))
                .build())
        net = ComputationGraph(conf).init(device="cpu")
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(3)],
            score_calculator=DataSetLossCalculator(
                _iris_like_iterator(seed=1)))
        result = EarlyStoppingTrainer(cfg, net, _iris_like_iterator()).fit()
        assert result.total_epochs == 3
        assert result.best_model is not None


def _sequences(n, seed):
    """Masked sequences of ragged length (3..8 steps of 2 features) whose
    class is the sign pattern of their running mean."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8, 2).astype(np.float32)
    lengths = rs.randint(3, 9, n)
    mask = (np.arange(8)[None] < lengths[:, None]).astype(np.float32)
    x *= mask[..., None]
    mean = x.sum(1) / lengths[:, None]
    cls = (mean[:, 0] > 0).astype(int) + 2 * (mean[:, 1] > 0)
    return x, np.eye(4, dtype=np.float32)[cls], mask


def _lstm_graph(pkg):
    import importlib

    g = importlib.import_module(f"{pkg}.nn.conf.graph_conf")
    b = importlib.import_module(f"{pkg}.nn.conf.builders")
    it = importlib.import_module(f"{pkg}.nn.conf.inputs")
    rec = importlib.import_module(f"{pkg}.nn.conf.layers.recurrent")
    core = importlib.import_module(f"{pkg}.nn.conf.layers.core")
    upd = importlib.import_module(f"{pkg}.nn.updater")
    return (b.NeuralNetConfiguration.builder().seed(3)
            .updater(upd.Adam(learning_rate=0.02))
            .graph_builder().add_inputs("in")
            .add_layer("lstm", rec.LSTM(n_out=6, activation="tanh"), "in")
            .add_vertex("last", g.LastTimeStepVertex(mask_input="in"), "lstm")
            .add_layer("out", core.OutputLayer(n_out=4, activation="softmax",
                                               loss="mcxent"), "last")
            .set_outputs("out")
            .set_input_types(it.InputType.recurrent(2))
            .build())


def test_early_stopping_lstm_graph_matches_jax():
    """An LSTM graph over masked ragged sequences under MaxEpochs(4) and
    ScoreImprovement(1): the port's run ends as JAX's, scores within rtol
    1e-4."""
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    jes = _jax_es()
    jnet = JGraph(_lstm_graph("deeplearning4j_tpu")).init()
    net = ComputationGraph(_lstm_graph("deeplearning4j_torch")).init(
        device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray,
                                           jax.device_get(jnet.params)), net)
    train = [_sequences(16, s) for s in range(3)]
    val = [_sequences(16, 10)]
    jres = jes.EarlyStoppingTrainer(jes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            jes.MaxEpochsTerminationCondition(4),
            jes.ScoreImprovementEpochTerminationCondition(1)],
        score_calculator=jes.DataSetLossCalculator(
            [JDataSet(x, y, m, None) for x, y, m in val])), jnet,
        [JDataSet(x, y, m, None) for x, y, m in train]).fit()
    res = EarlyStoppingTrainer(EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(4),
            ScoreImprovementEpochTerminationCondition(1)],
        score_calculator=DataSetLossCalculator(
            [DataSet(x, y, m, None) for x, y, m in val])), net,
        [DataSet(x, y, m, None) for x, y, m in train]).fit()
    _assert_runs_agree(res, jres)
    assert res.termination_reason == \
        TerminationReason.EPOCH_TERMINATION_CONDITION
    assert net.iteration == jnet.iteration == 3 * res.total_epochs
    x, _, m = val[0]
    np.testing.assert_allclose(res.best_model.output(x, masks=[m]).numpy(),
                               np.asarray(jres.best_model.output(
                                   x, masks=[m])), atol=1e-4, rtol=0)
