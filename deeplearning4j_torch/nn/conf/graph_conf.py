"""Graph configuration (port of the parts of
``deeplearning4j_tpu/nn/conf/graph_conf.py`` the TransformerLM needs): layer
vertices, ``ElementWiseVertex(op="add")``, the configuration, a builder and
the topological order. The dataclasses carry the JAX package's fields and
class names, so ``to_json``/``from_json`` read and write its
``configuration.json``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import Layer
from deeplearning4j_torch.nn.updater import Sgd, Updater
from deeplearning4j_torch.utils import serde
from deeplearning4j_torch.utils.serde import register_serializable


@dataclass
class GraphVertex:
    name: Optional[str] = None

    def param_order(self) -> list:
        return []

    def init_params(self, gen, dtype, device):
        return {}

    def output_size(self, sizes: list) -> int:
        return sizes[0]

    def forward(self, params, state, inputs, *, masks=None):
        raise NotImplementedError

    def feed_forward_mask(self, masks):
        """Propagate input time-masks (first non-None)."""
        for m in masks or ():
            if m is not None:
                return m
        return None


@register_serializable
@dataclass
class LayerVertex(GraphVertex):
    """A Layer inside the graph. ``preprocessor`` is not ported (ROADMAP
    A7) and raises where it would act; ``remat`` (recompute the vertex's
    activations in the backward to save memory) changes no number, and the
    port keeps the activations."""

    layer: Optional[Layer] = None
    preprocessor: Optional[object] = None
    remat: bool = False

    def param_order(self):
        return self.layer.param_order()

    def init_params(self, gen, dtype, device):
        return self.layer.init_params(gen, dtype, device)

    def output_size(self, sizes):
        self.layer.set_n_in(sizes[0])
        return self.layer.output_size(sizes[0])

    def forward(self, params, state, inputs, *, masks=None):
        if self.preprocessor is not None:
            raise NotImplementedError(
                f"vertex '{self.name}': input preprocessors are not ported "
                "yet (ROADMAP A7)")
        mask = masks[0] if masks else None
        return self.layer.forward(params, state, inputs[0], mask=mask)


@register_serializable
@dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise combine of its inputs; only ``op="add"`` is ported."""

    op: str = "add"

    def forward(self, params, state, inputs, *, masks=None):
        if self.op.lower() != "add":
            raise ValueError(f"ElementWiseVertex op '{self.op}' is not "
                             "ported (only 'add')")
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return out, state


@register_serializable
@dataclass
class ComputationGraphConfiguration:
    """The finalised DAG config, with ``topo_order`` computed once at build
    and serialized. ``backprop_type="tbptt"`` and ``pretrain`` act in
    ``fit`` and ``compute_dtype`` in every forward; none is ported yet
    (ROADMAP A6) and each raises there."""

    network_inputs: list = field(default_factory=list)
    network_outputs: list = field(default_factory=list)
    vertices: dict = field(default_factory=dict)        # {name: GraphVertex}
    vertex_inputs: dict = field(default_factory=dict)   # {name: [inputs]}
    topo_order: list = field(default_factory=list)
    input_types: Optional[list] = None
    seed: int = 0
    updater: Updater = field(default_factory=lambda: Sgd(learning_rate=0.1))
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    pretrain: bool = False
    dtype: str = "float32"
    compute_dtype: Optional[str] = None

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        conf = serde.from_json(s)
        if not isinstance(conf, ComputationGraphConfiguration):
            raise ValueError(f"JSON holds a {type(conf).__name__}, not a "
                             "ComputationGraphConfiguration")
        return conf

    def finalize(self) -> "ComputationGraphConfiguration":
        """Fill each layer's defaults and infer every ``n_in`` from the
        input types, in topological order (what ``build`` does; a loaded
        configuration arrives with both already set, and is unchanged)."""
        sizes = dict(zip(self.network_inputs,
                         [t.flat_size() for t in self.input_types or []]))
        for name in self.topo_order:
            v = self.vertices[name]
            if isinstance(v, LayerVertex):
                v.layer.finalize()
            ins = [sizes.get(k) for k in self.vertex_inputs[name]]
            if all(s is not None for s in ins):
                sizes[name] = v.output_size(ins)
        return self


class GraphBuilder:
    """``NeuralNetConfiguration.builder().graph_builder()`` reduced to what
    the TransformerLM conf calls."""

    def __init__(self, seed: int = 123, dtype: str = "float32"):
        self._conf = ComputationGraphConfiguration(seed=seed, dtype=dtype)

    def updater(self, u: Updater):
        """The updater ``fit`` trains with (JAX: the builder's
        ``.updater(...)``)."""
        self._conf.updater = u
        return self

    def add_inputs(self, *names):
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType):
        """What each network input holds; their sizes give the first
        layers' ``n_in``."""
        self._conf.input_types = list(types)
        return self

    def add_layer(self, name, layer: Layer, *inputs):
        return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

    def add_vertex(self, name, vertex: GraphVertex, *inputs):
        if name in self._conf.vertices or name in self._conf.network_inputs:
            raise ValueError(f"duplicate vertex name '{name}'")
        vertex.name = name
        self._conf.vertices[name] = vertex
        self._conf.vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names):
        self._conf.network_outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf = self._conf
        conf.topo_order = topological_sort(conf.vertex_inputs,
                                           conf.network_inputs)
        return conf.finalize()


def topological_sort(vertex_inputs: dict, network_inputs: list) -> list:
    """Kahn's algorithm over vertex names with a FIFO queue, as the JAX
    package orders them (the order of the flat parameter vector); raises on
    cycles or dangling inputs."""
    names = list(vertex_inputs.keys())
    known = set(names) | set(network_inputs)
    for name, ins in vertex_inputs.items():
        for i in ins:
            if i not in known:
                raise ValueError(f"vertex '{name}' reads unknown input '{i}'")
    indeg = {n: sum(1 for i in vertex_inputs[n] if i not in network_inputs)
             for n in names}
    children: dict = {n: [] for n in names}
    for name, ins in vertex_inputs.items():
        for i in ins:
            if i in children:
                children[i].append(name)
    queue = [n for n in names if indeg[n] == 0]
    order = []
    while queue:
        n = queue.pop(0)
        order.append(n)
        for c in children[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                queue.append(c)
    if len(order) != len(names):
        raise ValueError(f"graph has a cycle through "
                         f"{[n for n in names if n not in order]}")
    return order
