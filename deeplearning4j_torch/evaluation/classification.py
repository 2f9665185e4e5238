"""Classification evaluation (a copy of
``deeplearning4j_tpu/evaluation/classification.py``, which imports no JAX;
the port keeps its own): accuracy, precision, recall, F1, top-N accuracy
and the confusion matrix. Predictions are the argmax over the class axis;
precision and recall are macro-averaged over the classes with at least one
true or predicted example; masked time steps are left out. Mergeable, and
JSON-serializable for moving counts between workers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[list] = None, top_n: int = 1):
        """top_n > 1 additionally tracks top-N accuracy (prediction counts
        as correct if the true class is among the N highest-probability
        classes — reference: Evaluation.java:72 ``Evaluation(int topN)``,
        topNCorrectCount/topNTotalCount)."""
        self.num_classes = num_classes
        self.label_names = labels
        self.top_n = int(top_n)
        self.top_n_correct = 0
        self.top_n_total = 0
        self.confusion: Optional[np.ndarray] = None

    def _ensure(self, n):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes), np.int64)

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: [B, C] (one-hot / prob) or [B, T, C] time series."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        self._ensure(labels.shape[-1])
        true_idx = np.argmax(labels, axis=-1)
        pred_idx = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        if self.top_n > 1:
            num_classes = predictions.shape[-1]
            if self.top_n >= num_classes:
                # top-N over all classes always contains the true class:
                # every example counts as correct (and argpartition's kth
                # would be out of range anyway)
                self.top_n_correct += int(true_idx.size)
            else:
                n = self.top_n
                top = np.argpartition(predictions, -n, axis=-1)[..., -n:]
                self.top_n_correct += int(
                    (top == true_idx[..., None]).any(-1).sum())
            self.top_n_total += int(true_idx.size)
        return self

    def merge(self, other: "Evaluation") -> "Evaluation":
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = other.confusion.copy()
        else:
            self.confusion += other.confusion
        return self

    # ---- metrics ----------------------------------------------------------
    def _counts(self):
        # nothing evaluated yet (e.g. a zero-batch worker in the
        # distributed-merge flow): every metric reads as 0, never crashes
        cm = (self.confusion if self.confusion is not None
              else np.zeros((1, 1), np.int64))
        tp = np.diag(cm).astype(float)
        fp = cm.sum(axis=0) - tp
        fn = cm.sum(axis=1) - tp
        return tp, fp, fn

    def accuracy(self) -> float:
        cm = self.confusion
        if cm is None:
            return 0.0  # nothing evaluated yet
        total = cm.sum()
        return float(np.diag(cm).sum() / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        tp, fp, _ = self._counts()
        if cls is not None:
            if self.confusion is None:
                return 0.0  # zero state: like the aggregate metrics
            d = tp[cls] + fp[cls]
            return float(tp[cls] / d) if d else 0.0
        valid = (tp + fp) > 0
        if not valid.any():
            return 0.0
        return float(np.mean(tp[valid] / (tp[valid] + fp[valid])))

    def recall(self, cls: Optional[int] = None) -> float:
        tp, _, fn = self._counts()
        if cls is not None:
            if self.confusion is None:
                return 0.0  # zero state: like the aggregate metrics
            d = tp[cls] + fn[cls]
            return float(tp[cls] / d) if d else 0.0
        valid = (tp + fn) > 0
        if not valid.any():
            return 0.0
        return float(np.mean(tp[valid] / (tp[valid] + fn[valid])))

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose true class is in the top-N predicted
        (reference: Evaluation.topNAccuracy). top_n=1 == accuracy()."""
        if self.top_n <= 1:
            return self.accuracy()
        return (self.top_n_correct / self.top_n_total
                if self.top_n_total else 0.0)

    def false_positive_rate(self, cls: int) -> float:
        if self.confusion is None:
            return 0.0  # zero state: like the aggregate metrics
        cm = self.confusion
        tp, fp, fn = self._counts()
        tn = cm.sum() - tp[cls] - fp[cls] - fn[cls]
        d = fp[cls] + tn
        return float(fp[cls] / d) if d else 0.0

    def to_json(self) -> str:
        """Serialize counts + config (reference: BaseEvaluation.toJson —
        the transport format for merging eval results across workers)."""
        import json
        return json.dumps({
            "@class": "Evaluation",
            "num_classes": self.num_classes,
            "labels": self.label_names,
            "top_n": self.top_n,
            "top_n_correct": self.top_n_correct,
            "top_n_total": self.top_n_total,
            "confusion": (self.confusion.tolist()
                          if self.confusion is not None else None),
        })

    @staticmethod
    def from_json(s: str) -> "Evaluation":
        import json
        d = json.loads(s)
        if d.get("@class") != "Evaluation":
            raise ValueError("not an Evaluation json")
        ev = Evaluation(num_classes=d["num_classes"], labels=d["labels"],
                        top_n=d["top_n"])
        ev.top_n_correct = d["top_n_correct"]
        ev.top_n_total = d["top_n_total"]
        if d["confusion"] is not None:
            ev.confusion = np.asarray(d["confusion"], np.int64)
        return ev

    def stats(self) -> str:
        names = self.label_names or [str(i) for i in range(self.num_classes or 0)]
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes: {self.num_classes}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
        ] + ([f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}"]
             if self.top_n > 1 else []) + [
            "",
            "=========================Confusion Matrix=========================",
        ]
        if self.confusion is not None:
            header = "     " + " ".join(f"{n:>6}" for n in names)
            lines.append(header)
            for i, row in enumerate(self.confusion):
                lines.append(f"{names[i]:>4} " + " ".join(f"{v:>6}" for v in row))
        return "\n".join(lines)
