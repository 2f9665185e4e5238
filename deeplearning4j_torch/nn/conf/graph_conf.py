"""Graph configuration (port of ``deeplearning4j_tpu/nn/conf/graph_conf.py``):
the vertices (a layer behind an optional input preprocessor and ``remat``;
merge, element-wise, subset, stack/unstack, scale, shift, L2 distance, L2
normalization, a standalone preprocessor, reshape, the pool-helper crop,
and the two rnn vertices ``LastTimeStepVertex`` and
``DuplicateToTimeSeriesVertex``), the configuration, a builder over the
global configuration (``nn/conf/builders.py``, TBPTT lengths included) and
the topological order. The dataclasses carry the JAX package's fields and
class names, so ``to_json``/``from_json`` read and write its
``configuration.json``. Layouts are NHWC and ``[B, T, F]``: the feature
axis is the last one, where ``MergeVertex`` concatenates and
``SubsetVertex`` slices.

A vertex's ``forward(params, state, inputs, *, masks, ctx, train, rng)``
gets ``ctx``: ``{"input_arrays": {network input: array}, "input_masks":
{network input: mask}}``, as the JAX vertices get it."""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.base import Layer
from deeplearning4j_torch.nn.conf.preprocessors import (default_preprocessor,
                                                        preprocessor_key)
from deeplearning4j_torch.nn.updater import Sgd, Updater
from deeplearning4j_torch.utils import serde
from deeplearning4j_torch.utils.serde import register_serializable


@dataclass
class GraphVertex:
    name: Optional[str] = None

    def finalize(self, g=None) -> None:
        pass

    def param_order(self) -> list:
        return []

    def init_params(self, gen, dtype, device):
        return {}

    def init_state(self, dtype, device):
        return {}

    def regularization_grad(self, params):
        return {}

    def output_type(self, input_types: list) -> InputType:
        return input_types[0]

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
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
    """A Layer inside the graph, behind an optional input preprocessor
    (keyed by ``preprocessor_key`` of the vertex's key). ``remat``: in
    training, the vertex's internal activations are recomputed in the
    backward instead of stored (``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint``); the dropout key is explicit, so the recompute
    draws the same mask."""

    layer: Optional[Layer] = None
    preprocessor: Optional[object] = None
    remat: bool = False

    def finalize(self, g=None) -> None:
        self.layer.finalize(g)

    def param_order(self):
        return self.layer.param_order()

    def init_params(self, gen, dtype, device):
        return self.layer.init_params(gen, dtype, device)

    def init_state(self, dtype, device):
        return self.layer.init_state(dtype, device)

    def regularization_grad(self, params):
        return self.layer.regularization_grad(params)

    def output_type(self, input_types):
        """Insert the default preprocessor where none is set, infer the
        layer's ``n_in`` and check it (what the JAX build does per
        vertex); returns the vertex's output type."""
        it = input_types[0]
        if self.preprocessor is None:
            self.preprocessor = default_preprocessor(it, self.layer)
        if self.preprocessor is not None:
            it = self.preprocessor.output_type(it)
        self.layer.set_n_in(it)
        self.layer.validate()
        return self.layer.output_type(it)

    def feed_forward_mask(self, masks):
        mask = masks[0] if masks else None
        if self.preprocessor is not None:
            mask = self.preprocessor.feed_forward_mask(mask)
        return self.layer.feed_forward_mask(mask)

    def preprocess(self, x, rng=None):
        """The vertex input after its preprocessor (if any)."""
        if self.preprocessor is None:
            return x
        return self.preprocessor.forward(x, rng=preprocessor_key(rng))

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        mask = masks[0] if masks else None
        x = inputs[0]
        if self.preprocessor is not None:
            x = self.preprocess(x, rng)
            mask = self.preprocessor.feed_forward_mask(mask)
        if self.remat and train:
            from torch.utils.checkpoint import checkpoint

            def run(p, xx, st, mk, k):
                return self.layer.forward(p, st, xx, mask=mk, train=True,
                                          rng=k)

            # the port draws no number from torch's RNG, so there is no RNG
            # state to stash for the recompute
            return checkpoint(run, params, x, state, mask, rng,
                              use_reentrant=False, preserve_rng_state=False)
        return self.layer.forward(params, state, x, mask=mask, train=train,
                                  rng=rng)


@register_serializable
@dataclass
class MergeVertex(GraphVertex):
    """Concatenation of the inputs along the feature (last) axis; the
    output type sums the channels (images), sizes (sequences) or flat
    sizes."""

    def output_type(self, input_types):
        first = input_types[0]
        if first.kind == "convolutional":
            return InputType.convolutional(
                first.height, first.width,
                sum(t.channels for t in input_types))
        if first.kind == "recurrent":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       first.timeseries_length)
        return InputType.feed_forward(sum(t.flat_size() for t in input_types))

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        return torch.cat(list(inputs), dim=-1), state


@register_serializable
@dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise combine of the inputs: ``add``, ``subtract`` (exactly two
    inputs), ``product``, ``average`` or ``max``."""

    op: str = "add"

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        op = self.op.lower()
        out = inputs[0]
        if op == "add":
            for x in inputs[1:]:
                out = out + x
        elif op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract requires exactly 2 inputs")
            out = inputs[0] - inputs[1]
        elif op == "product":
            for x in inputs[1:]:
                out = out * x
        elif op == "average":
            out = sum(inputs) / float(len(inputs))
        elif op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"Unknown ElementWiseVertex op '{self.op}'")
        return out, state


@register_serializable
@dataclass
class SubsetVertex(GraphVertex):
    """The feature-axis slice ``[from_index, to_index]``, both ends
    included."""

    from_index: int = 0
    to_index: int = 0

    def output_type(self, input_types):
        n = self.to_index - self.from_index + 1
        it = input_types[0]
        if it.kind == "recurrent":
            return InputType.recurrent(n, it.timeseries_length)
        if it.kind == "convolutional":
            return InputType.convolutional(it.height, it.width, n)
        return InputType.feed_forward(n)

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        return inputs[0][..., self.from_index:self.to_index + 1], state


@register_serializable
@dataclass
class StackVertex(GraphVertex):
    """Concatenation of the inputs along the batch (first) axis."""

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        return torch.cat(list(inputs), dim=0), state


@register_serializable
@dataclass
class UnstackVertex(GraphVertex):
    """Chunk ``from_index`` of ``stack_size`` equal batch chunks (``step =
    B // stack_size`` rows each)."""

    from_index: int = 0
    stack_size: int = 1

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step], state


@register_serializable
@dataclass
class ScaleVertex(GraphVertex):
    """``scale · x``."""

    scale: float = 1.0

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        return inputs[0] * self.scale, state


@register_serializable
@dataclass
class ShiftVertex(GraphVertex):
    """``x + shift``."""

    shift: float = 0.0

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        return inputs[0] + self.shift, state


@register_serializable
@dataclass
class L2Vertex(GraphVertex):
    """The L2 distance between two inputs per example, ``sqrt(sum d² +
    eps)`` into ``[B, 1]`` (``eps`` keeps the gradient finite at 0)."""

    eps: float = 1e-8

    def output_type(self, input_types):
        return InputType.feed_forward(1)

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        a, b = inputs[0], inputs[1]
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt((d * d).sum(dim=1, keepdim=True) + self.eps), state


@register_serializable
@dataclass
class L2NormalizeVertex(GraphVertex):
    """``x / sqrt(sum x² + eps)``, the sum over every non-batch axis."""

    eps: float = 1e-8

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt((flat * flat).sum(dim=1) + self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.dim() - 1)), state


@register_serializable
@dataclass
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex of its own; a stochastic one
    draws from ``preprocessor_key`` of the vertex's key, as a layer
    vertex's preprocessor does."""

    preprocessor: Optional[object] = None

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        return (self.preprocessor.forward(inputs[0],
                                          rng=preprocessor_key(rng)),
                state)

    def feed_forward_mask(self, masks):
        return self.preprocessor.feed_forward_mask(masks[0] if masks
                                                   else None)


@register_serializable
@dataclass
class ReshapeVertex(GraphVertex):
    """Row-major reshape of the non-batch axes to ``shape`` (numpy's
    order). Its output type is its input's, as in the JAX package."""

    shape: tuple = ()

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape)), state


@register_serializable
@dataclass
class PoolHelperVertex(GraphVertex):
    """Drops the first row and the first column of an NHWC activation (the
    crop imported GoogLeNet-style models carry)."""

    def output_type(self, input_types):
        it = input_types[0]
        return InputType.convolutional(it.height - 1, it.width - 1,
                                       it.channels)

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        return inputs[0][:, 1:, 1:, :], state


@register_serializable
@dataclass
class LastTimeStepVertex(GraphVertex):
    """``[B, T, F] -> [B, F]`` at each row's last active step under the mask
    of the network input ``mask_input`` (else the vertex input's own mask):
    the index of the LAST nonzero mask entry, step 0 for an all-masked row;
    without a mask, the last step. The mask ends here."""

    mask_input: Optional[str] = None

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        x = inputs[0]
        mask = None
        if self.mask_input is not None and ctx is not None:
            mask = ctx.get("input_masks", {}).get(self.mask_input)
        if mask is None and masks:
            mask = masks[0]
        if mask is None:
            return x[:, -1, :], state
        T = x.shape[1]
        steps = torch.arange(1, T + 1, dtype=torch.float32,
                             device=x.device)[None, :]
        idx = torch.argmax(steps * mask.to(torch.float32), dim=1)
        return x[torch.arange(x.shape[0], device=x.device), idx], state

    def feed_forward_mask(self, masks):
        return None


@register_serializable
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """``[B, F] -> [B, T, F]``, T the time length of the network input
    ``input_name`` (a broadcast view, no copy). The mask ends here."""

    input_name: Optional[str] = None

    def output_type(self, input_types):
        return InputType.recurrent(input_types[0].flat_size())

    def forward(self, params, state, inputs, *, masks=None, ctx=None,
                train=False, rng=None):
        x = inputs[0]
        T = ctx["input_arrays"][self.input_name].shape[1]
        return x[:, None, :].expand(x.shape[0], T, x.shape[1]), state

    def feed_forward_mask(self, masks):
        return None


@register_serializable
@dataclass
class ComputationGraphConfiguration:
    """The finalised DAG config, with ``topo_order`` computed once at build
    and serialized. ``compute_dtype`` is the training forward's dtype
    (``ComputationGraph._loss``); inference runs in ``dtype``.
    ``backprop_type="tbptt"`` trains a single-input graph's sequence
    batches by truncated BPTT in ``fit``; ``pretrain`` is stored and not
    read, as in the JAX package."""

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

    def finalize(self, g=None) -> "ComputationGraphConfiguration":
        """Fill each layer's None fields from the global conf ``g`` (else
        the defaults), then, in topological order, insert the default
        preprocessors and infer every ``n_in`` from the input types (what
        ``build`` does; a loaded configuration arrives with all of it
        set, and is unchanged)."""
        types = dict(zip(self.network_inputs, self.input_types or []))
        for name in self.topo_order:
            v = self.vertices[name]
            v.finalize(g)
            ins = [types.get(k) for k in self.vertex_inputs[name]]
            if all(t is not None for t in ins):
                types[name] = v.output_type(ins)
            elif isinstance(v, LayerVertex):
                v.layer.validate()
        return self


class GraphBuilder:
    """``NeuralNetConfiguration.builder()...graph_builder()``: the DAG over
    a global configuration, whose seed, updater, dtypes and layer defaults
    the built configuration takes."""

    def __init__(self, global_conf=None):
        from deeplearning4j_torch.nn.conf.builders import (
            NeuralNetConfiguration)

        self._g = global_conf if global_conf is not None \
            else NeuralNetConfiguration()
        self._conf = ComputationGraphConfiguration()

    def backprop_type(self, t: str, fwd_length: int = 20,
                      back_length: int = 20) -> "GraphBuilder":
        self._conf.backprop_type = t
        self._conf.tbptt_fwd_length = fwd_length
        self._conf.tbptt_back_length = back_length
        return self

    def t_bptt_lengths(self, fwd: int,
                       back: Optional[int] = None) -> "GraphBuilder":
        return self.backprop_type("tbptt", fwd,
                                  back if back is not None else fwd)

    def pretrain(self, flag: bool) -> "GraphBuilder":
        self._conf.pretrain = flag
        return self

    def add_inputs(self, *names):
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType):
        """What each network input holds; their sizes give the first
        layers' ``n_in``."""
        self._conf.input_types = list(types)
        return self

    def add_layer(self, name, layer: Layer, *inputs, preprocessor=None,
                  remat: bool = False):
        return self.add_vertex(
            name, LayerVertex(layer=layer, preprocessor=preprocessor,
                              remat=remat), *inputs)

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
        conf = copy.deepcopy(self._conf)
        g = self._g
        conf.seed = g.seed
        conf.updater = copy.deepcopy(g.updater)
        conf.dtype = g.dtype
        conf.compute_dtype = g.compute_dtype
        conf.topo_order = topological_sort(conf.vertex_inputs,
                                           conf.network_inputs)
        return conf.finalize(g)


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
