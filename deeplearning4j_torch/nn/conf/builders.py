"""The global configuration and its fluent builder (port of the graph half of
``deeplearning4j_tpu/nn/conf/builders.py``): ``NeuralNetConfiguration``
holds the hyperparameters every layer inherits where it leaves a field None
(activation, weight init, bias init, L1/L2, dropout, gradient
normalization), the updater, ``dtype`` and ``compute_dtype``;
``NeuralNetConfiguration.builder()...graph_builder()`` starts a
ComputationGraph. The MultiLayerNetwork ``list(...)`` builder is ROADMAP A7.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from deeplearning4j_torch.nn.updater import Sgd, Updater


@dataclass
class NeuralNetConfiguration:
    """Global hyperparameters, inherited by the layers at build time."""

    seed: int = 12345
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[object] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    updater: Updater = field(default_factory=lambda: Sgd(learning_rate=0.1))
    dtype: str = "float32"
    compute_dtype: Optional[str] = None

    @staticmethod
    def builder() -> "NeuralNetConfigurationBuilder":
        return NeuralNetConfigurationBuilder()


class NeuralNetConfigurationBuilder:
    def __init__(self):
        self._c = NeuralNetConfiguration()

    def seed(self, s: int):
        self._c.seed = int(s)
        return self

    def activation(self, a: str):
        self._c.activation = str(a).lower()
        return self

    def weight_init(self, w: str, dist=None):
        self._c.weight_init = str(w).lower()
        if dist is not None:
            self._c.dist = dist
        return self

    def dist(self, d):
        self._c.dist = d
        self._c.weight_init = "distribution"
        return self

    def bias_init(self, b: float):
        self._c.bias_init = float(b)
        return self

    def l1(self, v: float):
        self._c.l1 = float(v)
        return self

    def l2(self, v: float):
        self._c.l2 = float(v)
        return self

    def dropout(self, v: float):
        self._c.dropout = float(v)
        return self

    def gradient_normalization(self, mode: str):
        from deeplearning4j_torch.nn.gradient_normalization import MODES

        m = str(mode).lower()
        if m not in MODES:
            raise ValueError(f"Unknown gradient_normalization '{mode}'; "
                             f"choose one of {MODES}")
        self._c.gradient_normalization = m
        return self

    def gradient_normalization_threshold(self, t: float):
        self._c.gradient_normalization_threshold = float(t)
        return self

    def updater(self, u: Updater):
        self._c.updater = u
        return self

    def learning_rate(self, lr: float):
        self._c.updater.learning_rate = float(lr)
        return self

    def dtype(self, dt: str):
        self._c.dtype = dt
        return self

    def compute_dtype(self, dt: Optional[str]):
        self._c.compute_dtype = dt
        return self

    def graph_builder(self):
        from deeplearning4j_torch.nn.conf.graph_conf import GraphBuilder

        return GraphBuilder(self._c)

    def build(self) -> NeuralNetConfiguration:
        return self._c
