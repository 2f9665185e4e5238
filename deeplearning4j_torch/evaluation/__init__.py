"""Evaluation (port of ``deeplearning4j_tpu/evaluation``): classification,
binary, regression and ROC metrics, the serializable curves, and the
device-resident fused evaluator."""

from deeplearning4j_torch.evaluation.classification import Evaluation
from deeplearning4j_torch.evaluation.fused_eval import FusedEvalDriver
from deeplearning4j_torch.evaluation.curves import (Histogram,
                                                    PrecisionRecallCurve,
                                                    RocCurve)
from deeplearning4j_torch.evaluation.regression import RegressionEvaluation
from deeplearning4j_torch.evaluation.roc import ROC, ROCBinary, ROCMultiClass
from deeplearning4j_torch.evaluation.binary import EvaluationBinary
