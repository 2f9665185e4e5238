"""The port's evaluation (``evaluation/classification.py`` and the fused
device evaluator ``evaluation/fused_eval.py``) against the JAX package's:
the counts, accuracy, precision, recall, F1, top-N accuracy and the
confusion matrix are exactly JAX's, fused and unfused, including a short
tail batch that the fused evaluator pads with zero-weight rows, for a
MultiLayerNetwork and a ComputationGraph."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.evaluation.classification import Evaluation
from deeplearning4j_torch.utils.convert import params_from_jax
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.evaluation.classification import (
    Evaluation as JEvaluation)

pytestmark = pytest.mark.torch_port


def _same(ev, jev):
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    assert ev.confusion.dtype == jev.confusion.dtype
    assert (ev.top_n_correct, ev.top_n_total) == (jev.top_n_correct,
                                                  jev.top_n_total)
    for metric in ("accuracy", "precision", "recall", "f1",
                   "top_n_accuracy"):
        assert getattr(ev, metric)() == getattr(jev, metric)(), metric
    for c in range(ev.num_classes):
        for metric in ("precision", "recall", "f1", "false_positive_rate"):
            assert getattr(ev, metric)(c) == getattr(jev, metric)(c), \
                (metric, c)


@pytest.mark.parametrize("top_n", [1, 3, 7])
@pytest.mark.parametrize("series", [False, True])
def test_evaluation_counts_equal_jax(top_n, series):
    """Host counting over the same labels and predictions, in three
    batches (merged as the evaluators merge them), 2-D and masked time
    series."""
    rs = np.random.RandomState(top_n + 10 * series)
    ev, jev = Evaluation(top_n=top_n), JEvaluation(top_n=top_n)
    for _ in range(3):
        shape = (6, 5) if series else (11,)
        labels = np.eye(7, dtype=np.float32)[rs.randint(0, 7, shape)]
        preds = rs.rand(*shape, 7).astype(np.float32)
        mask = (rs.rand(*shape) > 0.3).astype(np.float32) if series \
            else None
        ev.eval(labels, preds, mask=mask)
        jev.eval(labels, preds, mask=mask)
    _same(ev, jev)
    assert Evaluation.from_json(ev.to_json()).to_json() == jev.to_json()


@pytest.fixture(scope="module")
def lenet_pair():
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_tpu.models.zoo import LeNet as JLeNet

    jnet = JLeNet(seed=6, input_shape=(12, 12, 1)).init()
    net = LeNet(seed=6, input_shape=(12, 12, 1)).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), net)
    return jnet, net


def _stream(n_batches, tail, seed, shape=(12, 12, 1), classes=10):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        n = tail if i == n_batches - 1 else 8
        out.append((rs.rand(n, *shape).astype(np.float32),
                    np.eye(classes, dtype=np.float32)[
                        rs.randint(0, classes, n)]))
    return out


@pytest.mark.parametrize("top_n", [1, 3])
@pytest.mark.parametrize("eval_batches", [None, 2])
def test_fused_equals_unfused_and_jax(lenet_pair, top_n, eval_batches):
    """Five batches of 8 and a tail of 3 (padded to 8 with zero-weight
    rows in the fused blocks): the port's fused and per-batch evaluators
    and the JAX package's fused evaluator give the same counts."""
    jnet, net = lenet_pair
    stream = _stream(6, 3, seed=top_n)
    fused = net.evaluate([DataSet(x, y) for x, y in stream], top_n=top_n,
                         eval_batches=eval_batches)
    plain = net.evaluate([DataSet(x, y) for x, y in stream], top_n=top_n,
                         fused=False)
    jev = jnet.evaluate([JDataSet(x, y) for x, y in stream], top_n=top_n)
    assert fused.confusion.sum() == 43
    _same(fused, plain)
    _same(fused, jev)
    assert abs(fused.eval_loss - jev.eval_loss) <= 1e-5 * abs(jev.eval_loss)


def test_graph_evaluate_equals_jax():
    """``ComputationGraph.evaluate`` (the JAX graph's, ``nn/graph.py:472``):
    a TINY TransformerLM over time-series labels with a labels mask, fused
    and per batch."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu.models.zoo import TransformerLM as JLM

    kw = dict(num_labels=11, max_length=8, d_model=16, n_heads=2,
              n_blocks=1, seed=3)
    jnet = JLM(**kw).init()
    net = TransformerLM(**kw).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), net)
    rs = np.random.RandomState(4)
    batches = []
    for n in (4, 4, 2):
        tok = np.eye(11, dtype=np.float32)[rs.randint(0, 11, (n, 8))]
        mask = (rs.rand(n, 8) > 0.25).astype(np.float32)
        batches.append((tok, mask))
    ds = [DataSet(t, t, labels_mask=m) for t, m in batches]
    jds = [JDataSet(t, t, labels_mask=m) for t, m in batches]
    fused = net.evaluate(ds, top_n=2)
    plain = net.evaluate(ds, top_n=2, fused=False)
    jev = jnet.evaluate(jds, top_n=2)
    assert fused.confusion.sum() == sum(int(m.sum()) for _, m in batches)
    _same(fused, plain)
    _same(fused, jev)


def test_fused_eval_counts_on_the_device_once(lenet_pair, monkeypatch):
    """The fused evaluator fetches from the device once per call: its
    accumulator is int32 on the net's device, and the host sees one copy
    (counted at ``Tensor.cpu``)."""
    from deeplearning4j_torch.evaluation import fused_eval

    _, net = lenet_pair
    seen = []
    real = fused_eval.init_accumulator

    def spy(num_classes, device):
        acc = real(num_classes, device)
        seen.append(acc)
        return acc

    monkeypatch.setattr(fused_eval, "init_accumulator", spy)
    cpu_calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        cpu_calls.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    net.evaluate([DataSet(x, y) for x, y in _stream(4, 8, seed=5)])
    assert len(seen) == 1 and seen[0]["confusion"].dtype == torch.int32
    assert cpu_calls == [(10 * 10 + 4,)]
