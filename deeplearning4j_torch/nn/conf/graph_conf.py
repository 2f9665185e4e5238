"""Graph configuration (port of the parts of
``deeplearning4j_tpu/nn/conf/graph_conf.py`` the TransformerLM needs): layer
vertices, ``ElementWiseVertex(op="add")``, the updater, a builder and the
topological order."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from deeplearning4j_torch.nn.conf.layers.base import Layer
from deeplearning4j_torch.nn.updater import Sgd, Updater


class GraphVertex:
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


@dataclass
class LayerVertex(GraphVertex):
    """A Layer inside the graph."""

    layer: Optional[Layer] = None

    def param_order(self):
        return self.layer.param_order()

    def init_params(self, gen, dtype, device):
        return self.layer.init_params(gen, dtype, device)

    def output_size(self, sizes):
        self.layer.set_n_in(sizes[0])
        return self.layer.output_size(sizes[0])

    def forward(self, params, state, inputs, *, masks=None):
        mask = masks[0] if masks else None
        return self.layer.forward(params, state, inputs[0], mask=mask)


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


@dataclass
class ComputationGraphConfiguration:
    vertices: dict = field(default_factory=dict)
    vertex_inputs: dict = field(default_factory=dict)
    network_inputs: list = field(default_factory=list)
    network_outputs: list = field(default_factory=list)
    input_sizes: list = field(default_factory=list)
    topo_order: list = field(default_factory=list)
    seed: int = 123
    dtype: str = "float32"
    updater: Updater = field(default_factory=lambda: Sgd(learning_rate=0.1))


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

    def set_input_sizes(self, *sizes):
        """Feature size of each network input (the recurrent InputType's
        ``size``)."""
        self._conf.input_sizes = [int(s) for s in sizes]
        return self

    def add_layer(self, name, layer: Layer, *inputs):
        if layer.name is None:
            layer.name = name
        return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

    def add_vertex(self, name, vertex: GraphVertex, *inputs):
        if name in self._conf.vertices or name in self._conf.network_inputs:
            raise ValueError(f"duplicate vertex name '{name}'")
        self._conf.vertices[name] = vertex
        self._conf.vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names):
        self._conf.network_outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf = self._conf
        conf.topo_order = _topo_sort(conf)
        sizes = dict(zip(conf.network_inputs, conf.input_sizes))
        for name in conf.topo_order:
            v = conf.vertices[name]
            if isinstance(v, LayerVertex):
                v.layer.finalize()
            sizes[name] = v.output_size(
                [sizes[k] for k in conf.vertex_inputs[name]])
        return conf


def _topo_sort(conf) -> list:
    """Kahn's algorithm over the vertex DAG, ties broken by insertion
    order."""
    known = set(conf.network_inputs) | set(conf.vertices)
    for name, ins in conf.vertex_inputs.items():
        for k in ins:
            if k not in known:
                raise ValueError(f"vertex '{name}' reads unknown input '{k}'")
    done = set(conf.network_inputs)
    order: list = []
    pending = list(conf.vertices)
    while pending:
        ready = [n for n in pending
                 if all(k in done for k in conf.vertex_inputs[n])]
        if not ready:
            raise ValueError(f"graph has a cycle through {pending}")
        for n in ready:
            order.append(n)
            done.add(n)
            pending.remove(n)
    return order
