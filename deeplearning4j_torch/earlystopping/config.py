"""``EarlyStoppingConfiguration`` and ``EarlyStoppingResult`` (a copy of the
JAX package's ``earlystopping/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class TerminationReason:
    """reference: EarlyStoppingResult.TerminationReason enum"""

    ERROR = "Error"
    ITERATION_TERMINATION_CONDITION = "IterationTerminationCondition"
    EPOCH_TERMINATION_CONDITION = "EpochTerminationCondition"


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object

    def get_best_model(self):
        return self.best_model


@dataclass
class EarlyStoppingConfiguration:
    """Builder-free dataclass config (the reference's Builder maps 1:1 to
    keyword arguments)."""

    epoch_termination_conditions: list = field(default_factory=list)
    iteration_termination_conditions: list = field(default_factory=list)
    score_calculator: Optional[object] = None
    model_saver: Optional[object] = None
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    def __post_init__(self):
        if self.model_saver is None:
            from deeplearning4j_torch.earlystopping.savers import \
                InMemoryModelSaver
            self.model_saver = InMemoryModelSaver()
