"""The configurations and their fluent builders (port of
``deeplearning4j_tpu/nn/conf/builders.py``): ``NeuralNetConfiguration``
holds the hyperparameters every layer inherits where it leaves a field None
(activation, weight init, bias init, L1/L2, dropout, gradient
normalization), the updater, ``dtype`` and ``compute_dtype``;
``NeuralNetConfiguration.builder()...list(...)`` builds a
``MultiLayerConfiguration`` (``ListBuilder``: ``n_in`` inference over the
input type and the shape preprocessors between layer kinds), and
``...graph_builder()`` a ComputationGraph.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.preprocessors import (InputPreProcessor,
                                                        default_preprocessor)
from deeplearning4j_torch.nn.updater import Sgd, Updater, get_updater
from deeplearning4j_torch.utils import serde
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class MultiLayerConfiguration:
    """The built sequential configuration: every layer's None fields
    filled, ``n_in`` set, and ``preprocessors[i]`` the shape adapter run
    before layer i. ``backprop_type="tbptt"`` makes ``fit`` train sequence
    batches by truncated BPTT in ``tbptt_fwd_length`` segments (a
    ``tbptt_back_length`` other than the forward length raises here, as in
    the JAX package); ``pretrain`` is stored and not read by ``fit``, as
    in the JAX package (``MultiLayerNetwork.pretrain`` is explicit)."""

    layers: list = field(default_factory=list)
    preprocessors: dict = field(default_factory=dict)  # {int: preprocessor}
    input_type: Optional[InputType] = None
    seed: int = 0
    updater: Updater = field(default_factory=lambda: Sgd(learning_rate=0.1))
    backprop_type: str = "standard"  # standard | tbptt
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    pretrain: bool = False
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    layer_input_types: list = field(default_factory=list)

    def __post_init__(self):
        # JSON object keys are strings
        self.preprocessors = {int(k): v
                              for k, v in self.preprocessors.items()}
        if (self.backprop_type == "tbptt"
                and self.tbptt_back_length != self.tbptt_fwd_length):
            raise ValueError(
                "tbptt_back_length != tbptt_fwd_length is not supported; "
                f"got fwd={self.tbptt_fwd_length}, "
                f"back={self.tbptt_back_length}")

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        conf = serde.from_json(s)
        if not isinstance(conf, MultiLayerConfiguration):
            raise ValueError(f"JSON holds a {type(conf).__name__}, not a "
                             "MultiLayerConfiguration")
        return conf

    def n_layers(self) -> int:
        return len(self.layers)


class ListBuilder:
    """``NeuralNetConfiguration.builder()...list(*layers)``: the layers
    over a global configuration; ``set_input_type`` drives ``n_in``
    inference and the preprocessor insertion at ``build``."""

    def __init__(self, global_conf, layers):
        self._g = global_conf
        self._layers = list(layers)
        self._input_type: Optional[InputType] = None
        self._preprocessors: dict = {}
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._pretrain = False

    def layer(self, layer, index: Optional[int] = None) -> "ListBuilder":
        if index is None:
            self._layers.append(layer)
        else:
            while len(self._layers) <= index:
                self._layers.append(None)
            self._layers[index] = layer
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    input_type = set_input_type

    def input_pre_processor(self, index: int,
                            p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[index] = p
        return self

    def backprop_type(self, t: str, fwd_length: int = 20,
                      back_length: int = 20) -> "ListBuilder":
        self._backprop_type = t
        self._tbptt_fwd = fwd_length
        self._tbptt_back = back_length
        return self

    def t_bptt_lengths(self, fwd: int,
                       back: Optional[int] = None) -> "ListBuilder":
        return self.backprop_type("tbptt", fwd,
                                  back if back is not None else fwd)

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def build(self) -> MultiLayerConfiguration:
        g = self._g
        layers = [copy.deepcopy(la) for la in self._layers]
        if any(la is None for la in layers):
            raise ValueError("Gap in layer list (a .layer(index=...) was "
                             "skipped)")
        preprocessors = dict(self._preprocessors)
        cur = self._input_type
        for i, layer in enumerate(layers):
            layer.finalize(g)
            if cur is not None:
                if i not in preprocessors:
                    auto = default_preprocessor(cur, layer)
                    if auto is not None:
                        preprocessors[i] = auto
                if i in preprocessors:
                    cur = preprocessors[i].output_type(cur)
                layer.set_n_in(cur)
                layer.validate()
                cur = layer.output_type(cur)
            else:
                layer.validate()
        return MultiLayerConfiguration(
            layers=layers, preprocessors=preprocessors,
            input_type=self._input_type, seed=g.seed,
            updater=copy.deepcopy(g.updater),
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back, pretrain=self._pretrain,
            dtype=g.dtype, compute_dtype=g.compute_dtype)


@register_serializable
@dataclass
class NeuralNetConfiguration:
    """Global hyperparameters, inherited by the layers at build time.
    ``optimization_algo`` names what ``optimize.solvers.Solver`` runs
    (JAX's field and default)."""

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
    optimization_algo: str = "stochastic_gradient_descent"

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

    def updater(self, u, learning_rate: Optional[float] = None):
        """An ``Updater``, or a name (``"adam"``, ``"rmsprop"``, ...)
        resolved by ``nn.updater.get_updater`` with ``learning_rate``."""
        self._c.updater = get_updater(u, learning_rate)
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

    def optimization_algo(self, algo: str):
        self._c.optimization_algo = algo
        return self

    def list(self, *layers) -> ListBuilder:
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        return ListBuilder(self._c, layers)

    def graph_builder(self):
        from deeplearning4j_torch.nn.conf.graph_conf import GraphBuilder

        return GraphBuilder(self._c)

    def build(self) -> NeuralNetConfiguration:
        return self._c
