"""Score calculators (a copy of the JAX package's
``earlystopping/scorecalc.py``).

``DataSetLossCalculator`` averages the net's ``score`` (the loss with the
L1/L2 penalty) over a validation iterator, per example or per batch; one
class covers both net types, which share ``score``.
"""

from __future__ import annotations


class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        total = 0.0
        n = 0
        for ds in self.iterator:
            b = ds.num_examples()
            total += net.score(ds) * (b if self.average else 1.0)
            n += b if self.average else 1
        return total / max(n, 1)


class EvaluationScoreCalculator(ScoreCalculator):
    """Score = 1 - accuracy on a validation iterator, so 'minimize score'
    maximizes accuracy (the reference gained this class post-0.8; provided for
    API completeness)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, net) -> float:
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        ev = net.evaluate(self.iterator)
        return 1.0 - ev.accuracy()
