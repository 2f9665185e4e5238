"""ROC and AUC evaluation (a copy of ``deeplearning4j_tpu/evaluation/roc.py``,
which imports no JAX; the port keeps its own): ``ROC`` (binary), ``ROCBinary``
(per output) and ``ROCMultiClass`` (one against all), host numpy.
``threshold_steps > 0`` evaluates at that many fixed thresholds;
``threshold_steps=0`` (the default) at every distinct score, the exact
AUC. A mask drops the entries it zeroes.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_torch.evaluation.curves import (PrecisionRecallCurve,
                                                    RocCurve, trapezoid)


class ROC:
    """Binary ROC: labels [B] or [B,1] or one-hot [B,2]; probs same shape."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self.scores: list = []
        self.targets: list = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, float)
        predictions = np.asarray(predictions, float)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        if mask is not None:
            m = np.asarray(mask).astype(bool).reshape(-1)
            labels, predictions = labels[m], predictions[m]
        self.targets.append(labels)
        self.scores.append(predictions)
        return self

    def merge(self, other: "ROC"):
        self.targets.extend(other.targets)
        self.scores.extend(other.scores)
        return self

    def _collect(self):
        return np.concatenate(self.targets), np.concatenate(self.scores)

    def roc_curve(self):
        """Returns (fpr, tpr, thresholds)."""
        t, s = self._collect()
        if self.threshold_steps > 0:
            thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
        else:
            thresholds = np.concatenate([[np.inf], np.sort(np.unique(s))[::-1]])
        pos = t.sum()
        neg = len(t) - pos
        tpr = np.array([(s >= th).astype(float)[t > 0.5].sum() / max(pos, 1)
                        for th in thresholds])
        fpr = np.array([(s >= th).astype(float)[t <= 0.5].sum() / max(neg, 1)
                        for th in thresholds])
        order = np.argsort(fpr, kind="stable")
        return fpr[order], tpr[order], thresholds[order]

    def calculate_auc(self) -> float:
        fpr, tpr, _ = self.roc_curve()
        return float(trapezoid(tpr, fpr))

    def precision_recall_curve(self):
        t, s = self._collect()
        thresholds = np.sort(np.unique(s))[::-1]
        prec, rec = [], []
        pos = max(t.sum(), 1)
        for th in thresholds:
            pred = s >= th
            tp = (pred & (t > 0.5)).sum()
            prec.append(tp / max(pred.sum(), 1))
            rec.append(tp / pos)
        return np.array(rec), np.array(prec), thresholds

    def calculate_auprc(self) -> float:
        rec, prec, _ = self.precision_recall_curve()
        order = np.argsort(rec, kind="stable")
        return float(trapezoid(prec[order], rec[order]))

    def get_roc_curve(self):
        """The ROC curve as a serializable ``RocCurve``."""
        fpr, tpr, th = self.roc_curve()
        return RocCurve(thresholds=[float(x) for x in th],
                        fpr=[float(x) for x in fpr],
                        tpr=[float(x) for x in tpr])

    def get_precision_recall_curve(self):
        """The precision-recall curve as a serializable
        ``PrecisionRecallCurve``."""
        rec, prec, th = self.precision_recall_curve()
        return PrecisionRecallCurve(thresholds=[float(x) for x in th],
                                    precision=[float(x) for x in prec],
                                    recall=[float(x) for x in rec])


class ROCBinary:
    """One independent binary ROC per output."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self.rocs: list = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, float)
        predictions = np.asarray(predictions, float)
        n_out = labels.shape[-1]
        if not self.rocs:
            self.rocs = [ROC(self.threshold_steps) for _ in range(n_out)]
        for i in range(n_out):
            self.rocs[i].eval(labels[..., i], predictions[..., i], mask)
        return self

    def merge(self, other: "ROCBinary"):
        if not self.rocs:
            self.rocs = other.rocs
        else:
            for a, b in zip(self.rocs, other.rocs):
                a.merge(b)
        return self

    def calculate_auc(self, output: int) -> float:
        return self.rocs[output].calculate_auc()


class ROCMultiClass:
    """One-vs-all ROC per class."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self.rocs: list = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, float)
        predictions = np.asarray(predictions, float)
        n_cls = labels.shape[-1]
        if not self.rocs:
            self.rocs = [ROC(self.threshold_steps) for _ in range(n_cls)]
        for i in range(n_cls):
            self.rocs[i].eval(labels[..., i], predictions[..., i], mask)
        return self

    def merge(self, other: "ROCMultiClass"):
        if not self.rocs:
            self.rocs = other.rocs
        else:
            for a, b in zip(self.rocs, other.rocs):
                a.merge(b)
        return self

    def calculate_auc(self, cls: int) -> float:
        return self.rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.rocs]))
