"""Classification-result helpers (port of ``deeplearning4j_tpu/nn/simple.py``,
a host numpy copy): ``RankClassificationResult`` ranks each example's
class probabilities, ``BinaryClassificationResult`` thresholds a binary
output. Tensors on any device are read back to the host first."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):            # a torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class RankClassificationResult:
    """Ranked view over class probabilities [B, C]; the order is numpy's
    ``argsort`` of the negated probabilities (ties keep the lower class
    first)."""

    def __init__(self, probabilities, labels: Optional[List[str]] = None):
        self.probabilities = _host(probabilities)
        if self.probabilities.ndim != 2:
            raise ValueError("probabilities must be [batch, classes]")
        c = self.probabilities.shape[1]
        self.labels = (list(labels) if labels is not None
                       else [str(i) for i in range(c)])
        if len(self.labels) != c:
            raise ValueError("labels length != number of classes")
        # descending probability order per example
        self._order = np.argsort(-self.probabilities, axis=1)

    def ranked_classes(self, example: int) -> List[str]:
        """All labels for one example, best first."""
        return [self.labels[j] for j in self._order[example]]

    def max_output(self) -> List[str]:
        """Top-1 label per example."""
        return [self.labels[j] for j in self._order[:, 0]]

    def probability(self, example: int, label: str) -> float:
        return float(self.probabilities[example, self.labels.index(label)])


class BinaryClassificationResult:
    """Thresholded binary view over probabilities [B] / [B,1] / [B,2]
    (the positive class is column 1 of a [B, 2] input)."""

    def __init__(self, probabilities, threshold: float = 0.5):
        p = _host(probabilities)
        if p.ndim == 2:
            if p.shape[1] > 2:
                raise ValueError(
                    f"binary result needs [B], [B,1] or [B,2] input, got "
                    f"{p.shape} — use RankClassificationResult for "
                    "multiclass output")
            p = p[:, 1] if p.shape[1] == 2 else p[:, 0]
        elif p.ndim != 1:
            raise ValueError(f"binary result needs [B], [B,1] or [B,2] "
                             f"input, got {p.shape}")
        self.probabilities = p
        self.threshold = float(threshold)

    def decisions(self) -> np.ndarray:
        return (self.probabilities >= self.threshold).astype(np.int64)

    def positive_count(self) -> int:
        return int(self.decisions().sum())
