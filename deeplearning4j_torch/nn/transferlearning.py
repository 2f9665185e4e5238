"""Transfer learning (port of ``deeplearning4j_tpu/nn/transferlearning.py``):
rebuild a trained net with frozen layers and new heads.

Freezing wraps a layer in ``FrozenLayer`` (``nn/conf/layers/misc.py``),
whose forward detaches its parameters and runs the inner layer in
inference mode: its gradients are zero, so every updater leaves its leaves
bitwise unchanged, and a frozen batch norm normalizes by its running
statistics and never moves them. ``TransferLearning.Builder`` (a
MultiLayerNetwork) and ``TransferLearning.GraphBuilder`` (a
ComputationGraph) copy the kept layers' parameters and state from the
original net (cloned, on its device); replaced layers draw new weights from
the port's generator. ``TransferLearningHelper`` runs the frozen part once
per dataset (``featurize``) and trains the unfrozen tail on the features
(``fit_featurized``); beyond the JAX helper, which takes a
MultiLayerNetwork only, it also takes a graph, whose tail is the sub-graph
of the unfrozen vertices fed by the frozen vertices they read.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration, GraphVertex, LayerVertex,
    topological_sort)
from deeplearning4j_torch.nn.conf.layers.misc import FrozenLayer
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class FineTuneConfiguration:
    """Global overrides for every unfrozen layer and for the network
    configuration; only the fields that are set override."""

    seed: Optional[int] = None
    updater: Optional[object] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None
    learning_rate: Optional[float] = None

    def apply_to_layer(self, layer) -> None:
        if isinstance(layer, FrozenLayer):
            return  # frozen layers keep their configuration
        for f in ("activation", "weight_init", "bias_init", "l1", "l2",
                  "l1_bias", "l2_bias", "dropout", "learning_rate"):
            v = getattr(self, f)
            if v is not None and hasattr(layer, f):
                setattr(layer, f, v)

    def apply_to_conf(self, conf) -> None:
        if self.seed is not None:
            conf.seed = self.seed
        if self.updater is not None:
            conf.updater = copy.deepcopy(self.updater)
        elif self.learning_rate is not None and hasattr(conf.updater,
                                                        "learning_rate"):
            conf.updater.learning_rate = self.learning_rate


def _freeze(layer):
    return layer if isinstance(layer, FrozenLayer) else FrozenLayer(inner=layer)


def _cloned(tree: dict) -> dict:
    return {k: t.clone() for k, t in tree.items()}


def _global(conf) -> NeuralNetConfiguration:
    """The global configuration a rebuilt net takes: the seed, updater and
    dtype of ``conf`` (not its ``compute_dtype``, as in the JAX
    package)."""
    return NeuralNetConfiguration(seed=conf.seed,
                                  updater=copy.deepcopy(conf.updater),
                                  dtype=conf.dtype)


def _builder(g: NeuralNetConfiguration):
    nb = NeuralNetConfiguration.builder()
    nb._c = g
    return nb


class TransferLearning:
    """The entry points ``TransferLearning.Builder`` (MultiLayerNetwork)
    and ``TransferLearning.GraphBuilder`` (ComputationGraph)."""

    class Builder:
        def __init__(self, orig: MultiLayerNetwork):
            self._orig = orig
            self._conf = copy.deepcopy(orig.conf)
            self._layers = list(self._conf.layers)
            # the original index each kept layer copies from; None draws
            self._sources = list(range(len(self._layers)))
            self._ftc: Optional[FineTuneConfiguration] = None
            self._frozen_till = -1

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, layer_num: int):
            """Freeze layers ``[0, layer_num]``."""
            self._frozen_till = layer_num
            return self

        def nout_replace(self, layer_num: int, n_out: int,
                         weight_init: Optional[str] = None, dist=None,
                         scheme_next: Optional[str] = None, dist_next=None):
            """Change ``layer_num``'s ``n_out``; it and the ``n_in`` side
            of the next layer with parameters draw new weights."""
            layer = self._layers[layer_num]
            inner = layer.inner if isinstance(layer, FrozenLayer) else layer
            inner.n_out = n_out
            if weight_init is not None:
                inner.weight_init = weight_init
            if dist is not None:
                inner.weight_init = "distribution"
                inner.dist = dist
            self._sources[layer_num] = None
            for j in range(layer_num + 1, len(self._layers)):
                nxt = self._layers[j]
                ninner = nxt.inner if isinstance(nxt, FrozenLayer) else nxt
                if hasattr(ninner, "n_in"):
                    ninner.n_in = 0  # inferred again at build
                if ninner.param_order():
                    if scheme_next is not None:
                        ninner.weight_init = scheme_next
                    if dist_next is not None:
                        ninner.weight_init = "distribution"
                        ninner.dist = dist_next
                    self._sources[j] = None
                    break
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            """Drop the last ``n`` layers."""
            if n <= 0:
                raise ValueError(f"remove_layers_from_output requires n >= 1, "
                                 f"got {n}")
            self._layers = self._layers[:-n]
            self._sources = self._sources[:-n]
            return self

        def add_layer(self, layer):
            self._layers.append(layer)
            self._sources.append(None)
            return self

        def set_input_pre_processor(self, layer_idx: int, p):
            self._conf.preprocessors[layer_idx] = p
            return self

        def build(self) -> MultiLayerNetwork:
            layers = [copy.deepcopy(la) for la in self._layers]
            if self._frozen_till >= 0:
                layers = [(_freeze(la) if i <= self._frozen_till else la)
                          for i, la in enumerate(layers)]
            g = _global(self._conf)
            if self._ftc is not None:
                self._ftc.apply_to_conf(g)
                for la in layers:
                    self._ftc.apply_to_layer(la)
            lb = _builder(g).list(*layers)
            if self._conf.input_type is not None:
                lb.set_input_type(self._conf.input_type)
            for i, p in self._conf.preprocessors.items():
                if i < len(layers):
                    lb.input_pre_processor(i, p)
            if self._conf.backprop_type == "tbptt":
                lb.t_bptt_lengths(self._conf.tbptt_fwd_length,
                                  self._conf.tbptt_back_length)
            new_conf = lb.build()
            net = MultiLayerNetwork(new_conf).init(device=self._orig.device)
            for i, src in enumerate(self._sources):
                if src is not None:
                    net.params[str(i)] = _cloned(self._orig.params[str(src)])
                    if str(src) in self._orig.state:
                        net.state[str(i)] = _cloned(
                            self._orig.state[str(src)])
            net.updater_state = new_conf.updater.init(net.params)
            return net

    class GraphBuilder:
        def __init__(self, orig: ComputationGraph):
            self._orig = orig
            self._conf = copy.deepcopy(orig.conf)
            self._copy_from = {n: n for n in self._conf.vertices}
            self._ftc: Optional[FineTuneConfiguration] = None
            self._frozen: set = set()

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, *vertex_names):
            """Freeze the named vertices and all their ancestors."""
            conf = self._conf
            stack = list(vertex_names)
            while stack:
                n = stack.pop()
                if n in self._frozen or n in conf.network_inputs:
                    continue
                self._frozen.add(n)
                stack.extend(conf.vertex_inputs.get(n, ()))
            return self

        def nout_replace(self, vertex_name: str, n_out: int,
                         weight_init: Optional[str] = None, dist=None):
            """Change a layer vertex's ``n_out``; the change flows through
            parameterless vertices to the next layers with parameters,
            which infer ``n_in`` again and draw new weights."""
            v = self._conf.vertices[vertex_name]
            if not isinstance(v, LayerVertex):
                raise ValueError(f"'{vertex_name}' is not a layer vertex")
            v.layer.n_out = n_out
            if weight_init is not None:
                v.layer.weight_init = weight_init
            if dist is not None:
                v.layer.weight_init = "distribution"
                v.layer.dist = dist
            self._copy_from[vertex_name] = None
            consumers: dict = {}
            for name, ins in self._conf.vertex_inputs.items():
                for i in ins:
                    consumers.setdefault(i, []).append(name)
            stack = list(consumers.get(vertex_name, ()))
            seen = set()
            while stack:
                name = stack.pop()
                if name in seen:
                    continue
                seen.add(name)
                c = self._conf.vertices[name]
                if isinstance(c, LayerVertex):
                    if hasattr(c.layer, "n_in"):
                        c.layer.n_in = 0
                    if c.layer.param_order():
                        self._copy_from[name] = None
                        continue  # a layer with parameters absorbs it
                stack.extend(consumers.get(name, ()))
            return self

        def remove_vertex_and_connections(self, name: str):
            """Remove a vertex and, recursively, every vertex reading it."""
            self._conf.vertices.pop(name)
            self._conf.vertex_inputs.pop(name)
            self._copy_from.pop(name, None)
            self._frozen.discard(name)
            for n, ins in list(self._conf.vertex_inputs.items()):
                if name in ins and n in self._conf.vertex_inputs:
                    self.remove_vertex_and_connections(n)
            self._conf.network_outputs = [o for o in
                                          self._conf.network_outputs
                                          if o != name]
            return self

        def remove_vertex_keep_connections(self, name: str):
            """Remove a single-input vertex, rewiring its consumers to its
            input."""
            ins = self._conf.vertex_inputs.pop(name)
            self._conf.vertices.pop(name)
            self._copy_from.pop(name, None)
            self._frozen.discard(name)
            if len(ins) != 1:
                raise ValueError("remove_vertex_keep_connections requires a "
                                 "single-input vertex")
            src = ins[0]
            for n, vins in self._conf.vertex_inputs.items():
                self._conf.vertex_inputs[n] = [src if i == name else i
                                               for i in vins]
            self._conf.network_outputs = [src if o == name else o
                                          for o in self._conf.network_outputs]
            return self

        def add_layer(self, name: str, layer, *inputs, preprocessor=None,
                      remat: bool = False):
            return self.add_vertex(
                name, LayerVertex(layer=layer, preprocessor=preprocessor,
                                  remat=remat), *inputs)

        def add_vertex(self, name: str, vertex: GraphVertex, *inputs):
            if name in self._conf.vertices:
                raise ValueError(f"Duplicate vertex '{name}'")
            vertex.name = name
            self._conf.vertices[name] = vertex
            self._conf.vertex_inputs[name] = list(inputs)
            self._copy_from[name] = None
            return self

        def set_outputs(self, *names):
            self._conf.network_outputs = list(names)
            return self

        def build(self) -> ComputationGraph:
            conf = self._conf
            for n in self._frozen:
                v = conf.vertices[n]
                if isinstance(v, LayerVertex):
                    v.layer = _freeze(v.layer)
            if self._ftc is not None:
                self._ftc.apply_to_conf(conf)
                for n, v in conf.vertices.items():
                    if isinstance(v, LayerVertex) and n not in self._frozen:
                        self._ftc.apply_to_layer(v.layer)
            gb = _builder(_global(conf)).graph_builder()
            gb.add_inputs(*conf.network_inputs)
            if conf.input_types is not None:
                gb.set_input_types(*conf.input_types)
            for n in topological_sort(conf.vertex_inputs,
                                      conf.network_inputs):
                gb.add_vertex(n, conf.vertices[n], *conf.vertex_inputs[n])
            gb.set_outputs(*conf.network_outputs)
            if conf.backprop_type == "tbptt":
                gb.t_bptt_lengths(conf.tbptt_fwd_length,
                                  conf.tbptt_back_length)
            new_conf = gb.build()
            net = ComputationGraph(new_conf).init(device=self._orig.device)
            for n, src in self._copy_from.items():
                if src is not None and n in net.params:
                    net.params[n] = _cloned(self._orig.params[src])
                    if src in self._orig.state:
                        net.state[n] = _cloned(self._orig.state[src])
            net.updater_state = new_conf.updater.init(net.params)
            return net


def _is_frozen_vertex(v) -> bool:
    return isinstance(v, LayerVertex) and isinstance(v.layer, FrozenLayer)


class TransferLearningHelper:
    """Runs the frozen part of a net once per dataset and trains the
    unfrozen tail on the cached features. A MultiLayerNetwork's frozen part
    is its leading run of ``FrozenLayer``s; a graph's is its frozen layer
    vertices and the parameterless vertices that read only frozen vertices
    or network inputs, and the tail's inputs are the frozen vertices the
    rest reads (``boundary``, in topological order)."""

    def __init__(self, net):
        self.net = net
        if isinstance(net, MultiLayerNetwork):
            self._init_mln()
        else:
            self._init_graph()

    def _init_mln(self):
        layers = self.net.conf.layers
        k = 0
        while k < len(layers) and isinstance(layers[k], FrozenLayer):
            k += 1
        if k == 0:
            raise ValueError("Network has no frozen layers")
        self._boundary = k
        tail = [copy.deepcopy(la) for la in layers[k:]]
        # the tail's layers carry their n_in: no input type is needed
        sub_conf = _builder(_global(self.net.conf)).list(*tail).build()
        sub_conf.preprocessors = {
            i - k: p for i, p in self.net.conf.preprocessors.items()
            if i >= k}
        self.sub_net = MultiLayerNetwork(sub_conf).init(
            params={str(i - k): self.net.params[str(i)]
                    for i in range(k, len(layers))},
            device=self.net.device)
        self.sub_net.state = {str(i - k): self.net.state.get(str(i), {})
                              for i in range(k, len(layers))}
        self.sub_net.updater_state = sub_conf.updater.init(
            self.sub_net.params)

    def _init_graph(self):
        conf = self.net.conf
        frozen: set = set()
        for name in conf.topo_order:
            v = conf.vertices[name]
            ins = conf.vertex_inputs[name]
            if _is_frozen_vertex(v) or (
                    not isinstance(v, LayerVertex) and all(
                        i in frozen or i in conf.network_inputs
                        for i in ins)):
                frozen.add(name)
        if not any(_is_frozen_vertex(conf.vertices[n]) for n in frozen):
            raise ValueError("Network has no frozen layers")
        tail = [n for n in conf.topo_order if n not in frozen]
        boundary = [n for n in conf.topo_order if n in frozen and any(
            n in conf.vertex_inputs[t] for t in tail)]
        if any(i in conf.network_inputs for t in tail
               for i in conf.vertex_inputs[t]):
            raise ValueError("an unfrozen vertex reads a network input: "
                             "the helper needs the frozen part in front")
        self._frozen = frozen
        self._boundary = boundary
        vertex_inputs = {n: list(conf.vertex_inputs[n]) for n in tail}
        sub_conf = ComputationGraphConfiguration(
            network_inputs=list(boundary),
            network_outputs=list(conf.network_outputs),
            vertices={n: copy.deepcopy(conf.vertices[n]) for n in tail},
            vertex_inputs=vertex_inputs,
            topo_order=topological_sort(vertex_inputs, boundary),
            seed=conf.seed, updater=copy.deepcopy(conf.updater),
            dtype=conf.dtype, compute_dtype=conf.compute_dtype)
        self.sub_net = ComputationGraph(sub_conf).init(
            params={n: self.net.params.get(n, {}) for n in tail},
            device=self.net.device)
        self.sub_net.state = {n: self.net.state.get(n, {}) for n in tail}
        self.sub_net.updater_state = sub_conf.updater.init(
            self.sub_net.params)

    def featurize(self, ds):
        """The DataSet with its features replaced by the activations at the
        frozen boundary (a MultiDataSet where a graph's boundary has more
        than one vertex)."""
        import torch

        from deeplearning4j_torch.datasets.dataset import (DataSet,
                                                           MultiDataSet)

        net = self.net
        dtype = getattr(torch, net.conf.dtype)
        if isinstance(net, MultiLayerNetwork):
            x = net._as_tensor(ds.features, dtype)
            mask = (None if ds.features_mask is None
                    else net._as_tensor(ds.features_mask, torch.float32))
            with torch.no_grad():
                feats, _, out_mask = net._forward(
                    net.params, net.state, x, mask, train=False, rng=None,
                    upto=self._boundary)
            return DataSet(feats.cpu().numpy(), ds.labels,
                           None if out_mask is None
                           else out_mask.cpu().numpy(), ds.labels_mask)
        conf = net.conf
        xs = ds.features if isinstance(ds, MultiDataSet) else [ds.features]
        acts = {k: net._as_tensor(a, dtype)
                for k, a in zip(conf.network_inputs, xs)}
        ctx = {"input_arrays": dict(acts), "input_masks": {}}
        with torch.no_grad():
            for name in conf.topo_order:
                if name not in self._frozen:
                    continue
                v = conf.vertices[name]
                acts[name], _ = v.forward(
                    net.params.get(name, {}), net.state.get(name, {}),
                    [acts[k] for k in conf.vertex_inputs[name]], masks=None,
                    ctx=ctx, train=False)
        feats = [acts[b].cpu().numpy() for b in self._boundary]
        if len(feats) == 1 and not isinstance(ds, MultiDataSet):
            return DataSet(feats[0], ds.labels, None, ds.labels_mask)
        return MultiDataSet(feats, ds.labels if isinstance(ds, MultiDataSet)
                            else [ds.labels])

    def fit_featurized(self, ds, epochs: int = 1):
        """Train the unfrozen tail on featurized data, then write its
        parameters and state back into the full net."""
        self.sub_net.fit(ds, epochs=epochs)
        if isinstance(self.net, MultiLayerNetwork):
            k = self._boundary
            for i in range(k, len(self.net.conf.layers)):
                self.net.params[str(i)] = self.sub_net.params[str(i - k)]
                sub_state = self.sub_net.state.get(str(i - k), {})
                if sub_state:
                    self.net.state[str(i)] = sub_state
            return self
        for n in self.sub_net.conf.topo_order:
            self.net.params[n] = self.sub_net.params.get(n, {})
            if self.sub_net.state.get(n):
                self.net.state[n] = self.sub_net.state[n]
        return self

    def output_featurized(self, features):
        if isinstance(features, (list, tuple)):
            return self.sub_net.output(*features)
        return self.sub_net.output(features)

    def unfrozen_mln(self):
        """The unfrozen tail (a ComputationGraph for a graph)."""
        return self.sub_net
