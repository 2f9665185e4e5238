"""Per-output binary evaluation (a copy of
``deeplearning4j_tpu/evaluation/binary.py``, which imports no JAX; the port
keeps its own): independent TP/FP/TN/FN counts per output unit at a
threshold (0.5 by default), host numpy. ``[B, T, C]`` inputs count the
steps the labels mask keeps."""

from __future__ import annotations

import numpy as np


class EvaluationBinary:
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._init_done = False

    def _ensure(self, n):
        if not self._init_done:
            self.tp = np.zeros(n)
            self.fp = np.zeros(n)
            self.tn = np.zeros(n)
            self.fn = np.zeros(n)
            self._init_done = True

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, float)
        predictions = np.asarray(predictions, float)
        if labels.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        self._ensure(labels.shape[-1])
        pred = predictions >= self.threshold
        lab = labels > 0.5
        self.tp += (pred & lab).sum(axis=0)
        self.fp += (pred & ~lab).sum(axis=0)
        self.tn += (~pred & ~lab).sum(axis=0)
        self.fn += (~pred & lab).sum(axis=0)
        return self

    def merge(self, other: "EvaluationBinary"):
        if not getattr(other, "_init_done", False):
            return self
        if not self._init_done:
            self.__dict__.update({k: (v.copy() if isinstance(v, np.ndarray) else v)
                                  for k, v in other.__dict__.items()})
            return self
        for k in ("tp", "fp", "tn", "fn"):
            setattr(self, k, getattr(self, k) + getattr(other, k))
        return self

    def accuracy(self, output: int) -> float:
        total = self.tp[output] + self.fp[output] + self.tn[output] + self.fn[output]
        return float((self.tp[output] + self.tn[output]) / total) if total else 0.0

    def precision(self, output: int) -> float:
        d = self.tp[output] + self.fp[output]
        return float(self.tp[output] / d) if d else 0.0

    def recall(self, output: int) -> float:
        d = self.tp[output] + self.fn[output]
        return float(self.tp[output] / d) if d else 0.0

    def f1(self, output: int) -> float:
        p, r = self.precision(output), self.recall(output)
        return 2 * p * r / (p + r) if (p + r) else 0.0
