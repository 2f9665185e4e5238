"""Termination conditions (a copy of the JAX package's
``earlystopping/termination.py``).

Epoch conditions see (epoch, score); iteration conditions see the per-minibatch
score. ``initialize()`` resets any internal state before a fit() run.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass


class EpochTerminationCondition:
    """reference: termination/EpochTerminationCondition.java"""

    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    """reference: termination/IterationTerminationCondition.java"""

    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


@dataclass
class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs (reference: MaxEpochsTerminationCondition.java)."""

    max_epochs: int

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


@dataclass
class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at/below a target (reference:
    BestScoreEpochTerminationCondition.java — 'lesser than or equal')."""

    best_expected_score: float

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.best_expected_score

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


@dataclass
class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement (reference:
    ScoreImprovementEpochTerminationCondition.java)."""

    max_epochs_without_improvement: int
    min_improvement: float = 0.0

    def initialize(self) -> None:
        self._best = None
        self._epochs_without = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if self._best is None or self._best - score > self.min_improvement:
            self._best = score
            self._epochs_without = 0
            return False
        self._epochs_without += 1
        return self._epochs_without > self.max_epochs_without_improvement

    def __str__(self):
        return ("ScoreImprovementEpochTerminationCondition("
                f"{self.max_epochs_without_improvement}, "
                f"{self.min_improvement})")


@dataclass
class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Elapsed-time budget, measured on the monotonic clock (reference:
    MaxTimeIterationTerminationCondition.java)."""

    max_seconds: float

    def initialize(self) -> None:
        # monotonic: a wall-clock step (NTP, VM migration) must neither
        # fire termination early nor extend the budget
        self._start = time.monotonic()

    def terminate(self, last_score: float) -> bool:
        return (time.monotonic() - self._start) >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


@dataclass
class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop if score exceeds a ceiling — divergence guard (reference:
    MaxScoreIterationTerminationCondition.java)."""

    max_score: float

    def terminate(self, last_score: float) -> bool:
        return last_score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop on NaN/Inf score (reference:
    InvalidScoreIterationTerminationCondition.java)."""

    def terminate(self, last_score: float) -> bool:
        return math.isnan(last_score) or math.isinf(last_score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"
