"""The port's host evaluation classes beyond ``Evaluation`` (``evaluation/
binary.py``, ``regression.py``, ``roc.py``, ``curves.py``) against the JAX
package's on the same numpy-seeded inputs: counts and metrics equal, the
curves' JSON strings identical; ``[B, T, C]`` inputs honour the labels
mask. The counterpart of ``tests/test_evaluation.py``'s curve classes,
plus the binary and ROC classes. Also ``EvaluativeListener`` over a port
net, against JAX's on the same weights.
"""

import json

import numpy as np
import pytest

import deeplearning4j_torch.evaluation as te
import deeplearning4j_tpu.evaluation as je

pytestmark = pytest.mark.torch_port


def _binary_inputs(seq, seed=0, n_out=3):
    rs = np.random.RandomState(seed)
    shape = (6, 5, n_out) if seq else (40, n_out)
    labels = (rs.rand(*shape) > 0.5).astype(np.float32)
    preds = rs.rand(*shape).astype(np.float32)
    mask = None
    if seq:
        mask = np.ones(shape[:2], np.float32)
        mask[2, 3:] = 0.0
        mask[4, 1] = 0.0
    return labels, preds, mask


def _roc_inputs(seed=0):
    rs = np.random.RandomState(seed)
    scores = rs.rand(200)
    targets = (scores + rs.randn(200) * 0.3 > 0.5).astype(float)
    return targets, scores


def test_exports_match_jax():
    names = ["Evaluation", "FusedEvalDriver", "Histogram",
             "PrecisionRecallCurve", "RocCurve", "RegressionEvaluation",
             "ROC", "ROCBinary", "ROCMultiClass", "EvaluationBinary"]
    for n in names:
        assert hasattr(te, n) and hasattr(je, n), n


@pytest.mark.parametrize("seq", [False, True], ids=["2d", "3d_masked"])
def test_evaluation_binary_matches_jax(seq):
    labels, preds, mask = _binary_inputs(seq)
    j = je.EvaluationBinary(threshold=0.4).eval(labels, preds, mask=mask)
    t = te.EvaluationBinary(threshold=0.4).eval(labels, preds, mask=mask)
    for k in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    for o in range(3):
        for m in ("accuracy", "precision", "recall", "f1"):
            assert getattr(t, m)(o) == getattr(j, m)(o)
    if seq:
        assert t.tp.sum() + t.fp.sum() + t.tn.sum() + t.fn.sum() == \
            3 * mask.sum()
    # merge, into an empty one and into a used one
    j2 = je.EvaluationBinary().merge(j).merge(
        je.EvaluationBinary(threshold=0.4).eval(labels, preds, mask=mask))
    t2 = te.EvaluationBinary().merge(t).merge(
        te.EvaluationBinary(threshold=0.4).eval(labels, preds, mask=mask))
    np.testing.assert_array_equal(t2.tp, j2.tp)
    np.testing.assert_array_equal(t2.tp, 2 * t.tp)


@pytest.mark.parametrize("seq", [False, True], ids=["2d", "3d_masked"])
def test_regression_evaluation_matches_jax(seq):
    rs = np.random.RandomState(3)
    shape = (6, 5, 2) if seq else (50, 2)
    labels = rs.randn(*shape)
    preds = labels + 0.3 * rs.randn(*shape)
    mask = None
    if seq:
        mask = np.ones(shape[:2])
        mask[1, 2:] = 0.0
    j = je.RegressionEvaluation().eval(labels, preds, mask=mask)
    t = te.RegressionEvaluation().eval(labels, preds, mask=mask)
    assert t.n == j.n == (int(mask.sum()) if seq else 50)
    for c in range(2):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "correlation_r2"):
            assert getattr(t, m)(c) == getattr(j, m)(c)
    assert t.average_mean_squared_error() == j.average_mean_squared_error()
    assert t.stats() == j.stats()
    jm = je.RegressionEvaluation().merge(j).merge(
        je.RegressionEvaluation().eval(labels[:3], preds[:3]))
    tm = te.RegressionEvaluation().merge(t).merge(
        te.RegressionEvaluation().eval(labels[:3], preds[:3]))
    assert tm.n == jm.n
    assert tm.mean_squared_error(1) == jm.mean_squared_error(1)


@pytest.mark.parametrize("steps", [0, 10], ids=["exact", "steps10"])
def test_roc_matches_jax(steps):
    targets, scores = _roc_inputs()
    j = je.ROC(threshold_steps=steps).eval(targets, scores)
    t = te.ROC(threshold_steps=steps).eval(targets, scores)
    for a, b in zip(t.roc_curve(), j.roc_curve()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.precision_recall_curve(), j.precision_recall_curve()):
        np.testing.assert_array_equal(a, b)
    assert t.calculate_auc() == j.calculate_auc()
    assert t.calculate_auprc() == j.calculate_auprc()
    # one-hot [B, 2] input and a mask
    onehot = np.stack([1 - targets, targets], 1)
    probs = np.stack([1 - scores, scores], 1)
    mask = (np.arange(200) % 7 != 0).astype(float)
    j = je.ROC(steps).eval(onehot, probs, mask=mask)
    t = te.ROC(steps).eval(onehot, probs, mask=mask)
    assert t.calculate_auc() == j.calculate_auc()
    assert sum(len(a) for a in t.targets) == mask.sum()


@pytest.mark.parametrize("cls", ["ROCBinary", "ROCMultiClass"])
def test_roc_per_output_matches_jax_on_masked_sequences(cls):
    rs = np.random.RandomState(5)
    if cls == "ROCMultiClass":
        labels = np.eye(4)[rs.randint(0, 4, (6, 5))]
        preds = rs.dirichlet(np.ones(4), (6, 5))
    else:
        labels, preds, _ = _binary_inputs(True, seed=5, n_out=4)
    mask = np.ones((6, 5))
    mask[0, 2:] = 0.0
    mask[3, 4] = 0.0
    j = getattr(je, cls)().eval(labels, preds, mask=mask)
    t = getattr(te, cls)().eval(labels, preds, mask=mask)
    for o in range(4):
        assert t.calculate_auc(o) == j.calculate_auc(o)
        assert len(t.rocs[o].targets[0]) == mask.sum()
    if cls == "ROCMultiClass":
        assert t.calculate_average_auc() == j.calculate_average_auc()
    j.merge(getattr(je, cls)().eval(labels, preds))
    t.merge(getattr(te, cls)().eval(labels, preds))
    assert t.calculate_auc(2) == j.calculate_auc(2)


class TestCurveSerde:
    def test_roc_curve_json_identical_and_roundtrips(self):
        targets, scores = _roc_inputs()
        jc = je.ROC().eval(targets, scores).get_roc_curve()
        roc = te.ROC().eval(targets, scores)
        tc = roc.get_roc_curve()
        assert tc.to_json() == jc.to_json()
        back = te.RocCurve.from_json(jc.to_json())
        assert back == tc
        assert back.calculate_auc() == roc.calculate_auc()
        assert je.RocCurve.from_json(tc.to_json()) == jc

    def test_pr_curve_json_identical_and_roundtrips(self):
        targets, scores = _roc_inputs()
        jc = je.ROC().eval(targets, scores).get_precision_recall_curve()
        roc = te.ROC().eval(targets, scores)
        tc = roc.get_precision_recall_curve()
        assert tc.to_json() == jc.to_json()
        back = te.PrecisionRecallCurve.from_json(tc.to_json())
        assert back == tc
        assert abs(back.calculate_auprc() - roc.calculate_auprc()) < 1e-12
        assert back.calculate_auprc() == jc.calculate_auprc()

    def test_histogram_roundtrip(self):
        h = te.Histogram(title="w", min=-1.0, max=1.0, counts=[1, 5, 9, 2])
        assert h.to_json() == je.Histogram(title="w", min=-1.0, max=1.0,
                                           counts=[1, 5, 9, 2]).to_json()
        assert te.Histogram.from_json(h.to_json()) == h

    def test_histogram_wraps_stats_pipeline_entry(self):
        entry = {"counts": [2, 3], "min": -0.5, "max": 0.5}
        h = te.Histogram.from_stats("0/W", entry)
        assert h.counts == [2, 3] and h.min == -0.5 and h.max == 0.5
        assert h.to_json() == je.Histogram.from_stats("0/W",
                                                      entry).to_json()

    def test_roc_curve_json_is_strict(self):
        roc = te.ROC().eval(np.array([1.0, 0.0, 1.0]),
                            np.array([0.9, 0.2, 0.7]))
        s = roc.get_roc_curve().to_json()
        assert "Infinity" not in s
        json.loads(s)
        assert te.RocCurve.from_json(s).thresholds[0] == float("inf")
        assert s == je.ROC().eval(np.array([1.0, 0.0, 1.0]),
                                  np.array([0.9, 0.2, 0.7])
                                  ).get_roc_curve().to_json()

    def test_wrong_class_rejected(self):
        with pytest.raises(ValueError, match="not a RocCurve"):
            te.RocCurve.from_json(te.Histogram().to_json())
        with pytest.raises(ValueError, match="not a Histogram"):
            te.Histogram.from_json(te.RocCurve().to_json())


def test_evaluative_listener_matches_jax():
    """Every N iterations the held-out evaluation lands in
    ``evaluations``; its counts equal JAX's listener's on the same
    weights and batches."""
    import jax

    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_torch.nn.updater import Sgd
    from deeplearning4j_torch.optimize.listeners import EvaluativeListener
    from deeplearning4j_torch.utils.convert import params_from_jax
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.zoo import LeNet as JLeNet
    from deeplearning4j_tpu.nn.updater import Sgd as JSgd
    from deeplearning4j_tpu.optimize.listeners import (
        EvaluativeListener as JEvaluativeListener)

    rs = np.random.RandomState(2)
    x = rs.rand(24, 12, 12, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 24)]
    jconf = JLeNet(input_shape=(12, 12, 1)).conf()
    jconf.updater = JSgd(learning_rate=0.05)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    jnet = JMLN(jconf).init()
    tconf = LeNet(input_shape=(12, 12, 1)).conf()
    tconf.updater = Sgd(learning_rate=0.05)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    tnet = MultiLayerNetwork(tconf).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray,
                                           jax.device_get(jnet.params)), tnet)
    seen = []
    jl = JEvaluativeListener([JDataSet(x[:12], y[:12])], frequency=2)
    tl = EvaluativeListener([DataSet(x[:12], y[:12])], frequency=2,
                            callback=lambda m, ev: seen.append(ev))
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    batches = [(x[i:i + 6], y[i:i + 6]) for i in range(0, 24, 6)]
    jnet.fit([JDataSet(a, b) for a, b in batches], fused_steps=1)
    tnet.fit([DataSet(a, b) for a, b in batches], fused_steps=1)
    assert [i for i, _ in tl.evaluations] == [i for i, _ in jl.evaluations] \
        == [2, 4]
    assert [ev for _, ev in tl.evaluations] == seen
    for (_, a), (_, b) in zip(tl.evaluations, jl.evaluations):
        np.testing.assert_array_equal(a.confusion, b.confusion)
