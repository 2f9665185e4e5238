"""Early stopping (port of ``deeplearning4j_tpu/earlystopping``, which
imports no JAX; the port keeps its own copy over its own nets):

- ``EarlyStoppingConfiguration``: the termination conditions, the score
  calculator and the model saver;
- the epoch and iteration termination conditions (``termination.py``);
- ``DataSetLossCalculator`` (the loss over a validation iterator, for
  either net type) and ``EvaluationScoreCalculator``;
- ``InMemoryModelSaver`` (a clone on the net's device) and
  ``LocalFileModelSaver`` (model zips through ``utils/model_serializer``);
- ``EarlyStoppingTrainer``: the fit loop, for a MultiLayerNetwork and a
  ComputationGraph alike (``EarlyStoppingGraphTrainer`` is the same
  class). It trains where the net lives.
"""

from deeplearning4j_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
)
from deeplearning4j_torch.earlystopping.savers import (
    InMemoryModelSaver,
    LocalFileModelSaver,
)
from deeplearning4j_torch.earlystopping.scorecalc import (
    DataSetLossCalculator,
    EvaluationScoreCalculator,
)
from deeplearning4j_torch.earlystopping.termination import (
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_torch.earlystopping.trainer import (
    EarlyStoppingGraphTrainer,
    EarlyStoppingTrainer,
)

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult",
    "InMemoryModelSaver", "LocalFileModelSaver",
    "DataSetLossCalculator", "EvaluationScoreCalculator",
    "MaxEpochsTerminationCondition", "BestScoreEpochTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "EarlyStoppingTrainer", "EarlyStoppingGraphTrainer",
]
