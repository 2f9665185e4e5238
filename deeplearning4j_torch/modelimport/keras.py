"""Keras h5 -> native config + weights (the port of
``deeplearning4j_tpu/modelimport/keras.py``: the same translation, into the
port's layers, on ``device``).

Reference: deeplearning4j-modelimport KerasModel.java:59,73-75 (parse the
``model_config`` JSON attribute from HDF5), :419-598 (layer-by-layer config
translation + weight copying), layers/Keras*.java translators,
preprocessors/TensorFlowCnnToFeedForwardPreProcessor.java (dim-ordering fix),
Hdf5Archive.java:46 (JavaCPP HDF5 — h5py here, no JNI).

Supported layer types (the reference's Keras-1 set, accepting Keras-2 config
spellings too): Dense, Convolution2D/Conv2D, MaxPooling2D, AveragePooling2D,
ZeroPadding2D, Flatten, Dropout, Activation, BatchNormalization, Embedding,
LSTM, GlobalAveragePooling2D/GlobalMaxPooling2D.

The port's parameter layouts are the JAX package's, so the numpy
translation below is JAX's line for line; only the last step differs: each
array becomes a tensor on the net's device in the dtype of the leaf it
replaces. A ``source`` is a path to an HDF5 file or an open h5py-like
object (``attrs``, ``in`` and item access; ``visititems`` where a group
lists no ``weight_names``), so the same translation runs from an
in-memory source where h5py is absent.

Layout notes (arrays are NHWC / [B,T,F]):
- conv kernels: tf dim-ordering h5 kernels are already HWIO — copied as-is;
  th (channels_first) kernels [out, in, kh, kw] are transposed to HWIO and
  flipped (Keras-1 th performs true convolution; see
  KerasConvolution weight init in the reference).
- Flatten after conv: our CnnToFeedForwardPreProcessor flattens NHWC; a
  Dense trained against th-ordered flatten gets its rows permuted
  (reference: TensorFlowCnnToFeedForwardPreProcessor).
- LSTM gates: Keras order (i, f, c, o) -> native (i, f, o, g) block
  permutation.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.convolution import (
    ConvolutionLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_torch.nn.conf.layers.core import (
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    OutputLayer,
)
from deeplearning4j_torch.nn.conf.graph_conf import (
    ElementWiseVertex,
    MergeVertex,
)
from deeplearning4j_torch.nn.conf.layers.normalization import BatchNormalization
from deeplearning4j_torch.nn.conf.layers.pooling import GlobalPoolingLayer
from deeplearning4j_torch.nn.conf.layers.recurrent import LSTM
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

_KERAS_ACT = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid",
    "tanh": "tanh", "softmax": "softmax", "hard_sigmoid": "hardsigmoid",
    "softplus": "softplus", "elu": "elu", "selu": "selu",
    "softsign": "softsign", "swish": "swish",
}


def _act(name):
    if name is None:
        return "identity"
    if name not in _KERAS_ACT:
        raise ValueError(f"Unsupported Keras activation '{name}'")
    return _KERAS_ACT[name]


def _cfg(layer):
    return layer.get("config", {})


class KerasLayerTranslator:
    """One Keras layer dict -> native layer config (reference: the
    KerasDense/KerasConvolution/... translator classes)."""

    def __init__(self, enforce_training_config: bool = False):
        self.enforce = enforce_training_config

    def translate(self, layer: dict, is_last: bool):
        cls = layer["class_name"]
        c = _cfg(layer)
        if cls == "Dense":
            n_out = c.get("output_dim") or c.get("units")
            act = _act(c.get("activation"))
            if is_last:
                loss = "mcxent" if act == "softmax" else "mse"
                return OutputLayer(n_out=n_out, activation=act, loss=loss)
            return DenseLayer(n_out=n_out, activation=act)
        if cls in ("Convolution2D", "Conv2D"):
            kh = c.get("nb_row") or (c.get("kernel_size") or [3, 3])[0]
            kw = c.get("nb_col") or (c.get("kernel_size") or [3, 3])[1]
            n_out = c.get("nb_filter") or c.get("filters")
            stride = tuple(c.get("subsample") or c.get("strides") or (1, 1))
            mode = ("same" if (c.get("border_mode") or c.get("padding"))
                    == "same" else "truncate")
            return ConvolutionLayer(n_out=n_out, kernel_size=(kh, kw),
                                    stride=stride, convolution_mode=mode,
                                    activation=_act(c.get("activation")))
        if cls in ("MaxPooling2D", "AveragePooling2D"):
            pool = tuple(c.get("pool_size") or (2, 2))
            stride = tuple(c.get("strides") or pool)
            return SubsamplingLayer(
                pooling_type="max" if cls.startswith("Max") else "avg",
                kernel_size=pool, stride=stride,
                convolution_mode=("same" if (c.get("border_mode")
                                             or c.get("padding")) == "same"
                                  else "truncate"))
        if cls == "ZeroPadding2D":
            p = c.get("padding") or (1, 1)
            if isinstance(p[0], (list, tuple)):
                (pt, pb), (pl, pr) = p
            else:
                pt = pb = p[0]
                pl = pr = p[1]
            return ZeroPaddingLayer(pad_top=pt, pad_bottom=pb, pad_left=pl,
                                    pad_right=pr)
        if cls == "Flatten":
            return "flatten"  # handled via preprocessor auto-insertion
        if cls == "Dropout":
            return DropoutLayer(dropout=c.get("p") or c.get("rate") or 0.5)
        if cls == "Activation":
            return ActivationLayer(activation=_act(c.get("activation")))
        if cls == "BatchNormalization":
            return BatchNormalization(eps=c.get("epsilon", 1e-5),
                                      decay=c.get("momentum", 0.9))
        if cls == "Embedding":
            return EmbeddingLayer(n_in=c.get("input_dim"),
                                  n_out=c.get("output_dim"),
                                  activation="identity")
        if cls == "LSTM":
            n_out = c.get("output_dim") or c.get("units")
            act = _act(c.get("activation"))
            gate = _act(c.get("inner_activation")
                        or c.get("recurrent_activation") or "sigmoid")
            return LSTM(n_out=n_out, activation=act, gate_activation=gate)
        if cls in ("GlobalAveragePooling2D", "GlobalMaxPooling2D"):
            return GlobalPoolingLayer(
                pooling_type="avg" if "Average" in cls else "max")
        if cls == "InputLayer":
            return None
        raise ValueError(f"Unsupported Keras layer type '{cls}'")

    def input_type(self, layer: dict, dim_ordering: str):
        """InputType from the first layer's batch_input_shape."""
        c = _cfg(layer)
        shape = c.get("batch_input_shape") or c.get("batch_shape")
        if shape is None:
            return None
        shape = [s for s in shape[1:]]  # drop batch dim
        if len(shape) == 3:
            if dim_ordering == "th":
                ch, h, w = shape
            else:
                h, w, ch = shape
            return InputType.convolutional(h, w, ch)
        if len(shape) == 2:
            return InputType.recurrent(shape[1], shape[0])
        if len(shape) == 1:
            return InputType.feed_forward(shape[0])
        return None


class KerasModelImport:
    """reference: KerasModelImport.java entry points."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path, quantize=None, device=None) -> MultiLayerNetwork:
        return import_keras_sequential_model_and_weights(
            path, quantize=quantize, device=device)

    @staticmethod
    def import_keras_model_and_weights(path, quantize=None, device=None):
        return import_keras_model_and_weights(path, quantize=quantize,
                                              device=device)


def _open(source):
    """``source`` opened for reading: an HDF5 path through h5py, or an
    already-open h5py-like object as it is."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        import h5py

        return h5py.File(source, "r")
    return contextlib.nullcontext(source)


def _as(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor on ``like``'s device in ``like``'s dtype."""
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=like.device,
                                                       dtype=like.dtype)


def _model_config(f) -> dict:
    raw = f.attrs.get("model_config")
    if raw is None:
        raise ValueError("No 'model_config' attribute in HDF5 file "
                         "(weights-only files are not importable as models)")
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8")
    return json.loads(raw)


def import_keras_model_and_weights(path, quantize=None, device=None):
    """Functional or Sequential model import. Sequential (and LINEAR
    functional) models become a MultiLayerNetwork; BRANCHED functional
    DAGs (residual adds, concat merges — the zoo-class models) become a
    ComputationGraph (reference: KerasModel.java:419-495 builds a
    ComputationGraphConfiguration.GraphBuilder; merge layers via
    layers/KerasMerge.java).

    ``quantize="int8"`` rewrites the imported weights to absmax
    per-channel int8 (optimize/quantize.py) before returning — the
    imported-then-quantized net serves through the same fused-dequant
    path as a quantized zoo model. The net lives on ``device`` (CUDA
    unless the caller passes another)."""
    with _open(path) as f:
        config = _model_config(f)
    if config["class_name"] == "Sequential":
        return import_keras_sequential_model_and_weights(
            path, quantize=quantize, device=device)
    cfg = config["config"]
    layers = cfg["layers"] if isinstance(cfg, dict) else cfg
    n_outputs = (len(_layer_refs(cfg.get("output_layers", [])))
                 if isinstance(cfg, dict) else 1)
    if n_outputs <= 1 and _is_linear(layers):
        # single-output linear chains keep the (simpler, flat-indexed)
        # sequential path; a multi-OUTPUT model must stay functional even
        # when its layer chain looks linear, or intermediate outputs are
        # silently dropped. The InputLayer stays in the list — it
        # contributes no layer but carries the input shape (Keras 3 puts
        # batch_shape only there)
        fake = {"class_name": "Sequential", "config": list(layers)}
        return _maybe_quantize(_import_sequential(path, fake, device),
                               quantize)
    return _maybe_quantize(_import_functional(path, config, device),
                           quantize)


def _maybe_quantize(net, quantize):
    if quantize is None:
        return net
    from deeplearning4j_torch.optimize.quantize import quantize_net
    return quantize_net(net, quantize)


def _inbound_names(layer: dict):
    """Input layer names of one functional-API layer, across config eras:
    Keras 1/2 ``[[["name", node, tensor], ...]]`` and Keras 3 legacy-h5
    ``[{"args": [__keras_tensor__...]}]`` (keras_history carries the
    producing layer name)."""
    nodes = layer.get("inbound_nodes") or []
    if not nodes:
        return []
    if len(nodes) > 1:
        raise ValueError(
            f"Layer '{layer.get('name')}' is shared (has "
            f"{len(nodes)} inbound nodes) — shared-layer reuse is not "
            "supported (the reference rejects these too)")
    node = nodes[0]
    names = []
    if isinstance(node, dict):  # Keras 3
        def collect(obj):
            if isinstance(obj, dict):
                if obj.get("class_name") == "__keras_tensor__":
                    names.append(obj["config"]["keras_history"][0])
                else:
                    for v in obj.values():
                        collect(v)
            elif isinstance(obj, (list, tuple)):
                for v in obj:
                    collect(v)
        collect(node.get("args", []))
        collect(node.get("kwargs", {}))
    else:  # Keras 1/2: list of [name, node_index, tensor_index, (kwargs)]
        for ref in node:
            names.append(ref[0] if isinstance(ref, (list, tuple)) else ref)
    return names


def _layer_refs(v):
    """Normalize input_layers/output_layers config entries to layer
    names: ['name', 0, 0] | [['a',0,0], ['b',0,0]] | ['a', 'b']."""
    if not isinstance(v, (list, tuple)):
        return [v]
    if v and not isinstance(v[0], (list, tuple)):
        # either a single ['name', n, t] triple or a list of names
        if len(v) >= 2 and isinstance(v[1], int):
            return [v[0]]
        return list(v)
    return [r[0] if isinstance(r, (list, tuple)) else r for r in v]


def _is_linear(layers) -> bool:
    """True when every non-input layer has exactly one inbound CONNECTION
    and nothing branches (each producer feeds at most one consumer). The
    inbound names are counted WITHOUT dedup: ``Add()([x, x])`` names the
    same tensor twice, but it is still a two-input merge — deduping would
    flatten it into a linear stack and silently import x + x as x. A
    model with several InputLayers is never linear — flattening disjoint
    input chains into one stack would mis-wire them."""
    if sum(1 for l in layers if l["class_name"] == "InputLayer") > 1:
        return False
    consumers: dict = {}
    for l in layers:
        if l["class_name"] == "InputLayer":
            continue
        try:
            ins = _inbound_names(l)
        except ValueError:
            return False
        if len(ins) > 1:
            return False
        for i in ins:
            consumers[i] = consumers.get(i, 0) + 1
    return all(c <= 1 for c in consumers.values())


# Keras merge-layer class -> (vertex factory). Concatenate merges along
# the feature axis (our MergeVertex); the rest are pointwise
# (ElementWiseVertex ops) — reference: layers/KerasMerge.java
_MERGE_CLASSES = {
    "Add": lambda c: ElementWiseVertex(op="add"),
    "Subtract": lambda c: ElementWiseVertex(op="subtract"),
    "Multiply": lambda c: ElementWiseVertex(op="product"),
    "Average": lambda c: ElementWiseVertex(op="average"),
    "Maximum": lambda c: ElementWiseVertex(op="max"),
    "Concatenate": lambda c: MergeVertex(),
}
_MERGE_MODES = {  # Keras-1 Merge(mode=...)
    "sum": "Add", "mul": "Multiply", "ave": "Average", "max": "Maximum",
    "concat": "Concatenate",
}


def _inbound_rank(layer: dict):
    """Tensor rank of the layer's inputs when the config records it
    (Keras 3 keeps each __keras_tensor__'s shape); None otherwise."""
    nodes = layer.get("inbound_nodes") or []
    for node in nodes:
        if not isinstance(node, dict):
            continue
        found = []

        def collect(obj):
            if isinstance(obj, dict):
                if obj.get("class_name") == "__keras_tensor__":
                    shape = obj.get("config", {}).get("shape")
                    if shape is not None:
                        found.append(len(shape))
                else:
                    for v in obj.values():
                        collect(v)
            elif isinstance(obj, (list, tuple)):
                for v in obj:
                    collect(v)
        collect(node.get("args", []))
        if found:
            return found[0]
    return None


def _merge_vertex(layer: dict):
    cls = layer["class_name"]
    if cls == "Merge":  # Keras 1
        mode = _cfg(layer).get("mode", "sum")
        if mode not in _MERGE_MODES:
            raise ValueError(f"Unsupported Keras-1 Merge mode '{mode}'")
        cls = _MERGE_MODES[mode]
    if cls not in _MERGE_CLASSES:
        return None
    if cls == "Concatenate":
        # only feature-axis (last-axis) merges map to MergeVertex, like
        # the reference's KerasMerge; "last axis" is rank-dependent —
        # axis=1 IS the feature axis of [B,F] Dense outputs
        axis = _cfg(layer).get("axis", -1)
        rank = _inbound_rank(layer)
        ok = (axis == -1 or (rank is not None and axis == rank - 1)
              or (rank is None and axis == 3))  # legacy NHWC assumption
        if not ok:
            raise ValueError(
                f"Concatenate axis {axis} unsupported for rank-{rank} "
                "inputs (feature-axis merge only, like the reference "
                "MergeVertex)")
    return _MERGE_CLASSES[cls](_cfg(layer))


def _import_functional(path, config: dict, device=None):
    """Branched functional DAG -> ComputationGraph with weights."""
    from deeplearning4j_torch.nn.graph import ComputationGraph

    cfg = config["config"]
    layers = cfg["layers"]
    translator = KerasLayerTranslator()

    dim_ordering = "tf"
    for ld in layers:
        d = _cfg(ld).get("dim_ordering") or _cfg(ld).get("data_format")
        if d:
            dim_ordering = {"channels_first": "th",
                            "channels_last": "tf"}.get(d, d)
            break

    output_names = _layer_refs(cfg.get("output_layers", []))
    input_names = _layer_refs(cfg.get("input_layers", []))

    builder = (NeuralNetConfiguration.builder().seed(12345).graph_builder())
    alias: dict = {}       # dropped layer name -> upstream effective name
    keras_names: list = [] # vertex names that carry weights
    input_types: dict = {}

    def resolve(name):
        while name in alias:
            name = alias[name]
        return name

    for ld in layers:
        cls = ld["class_name"]
        name = _cfg(ld).get("name") or ld.get("name")
        ins = [resolve(n) for n in _inbound_names(ld)]
        if cls == "InputLayer":
            it = translator.input_type(ld, dim_ordering)
            builder.add_inputs(name)
            if it is not None:
                input_types[name] = it
            continue
        mv = _merge_vertex(ld)
        if mv is not None:
            builder.add_vertex(name, mv, *ins)
            continue
        t = translator.translate(ld, is_last=(name in output_names))
        if t is None or t == "flatten":
            # flatten is absorbed by the builder's automatic
            # CnnToFeedForward preprocessor on the consumer (parity:
            # KerasModel.java:487 preprocessor insertion)
            alias[name] = ins[0]
            continue
        builder.add_layer(name, t, *ins)
        keras_names.append(name)

    if not input_names:
        raise ValueError("Functional model config lists no input_layers")
    missing = [n for n in input_names if n not in input_types]
    if missing:
        raise ValueError(f"Could not infer input shape for {missing} "
                         "(no batch shape on the InputLayer)")
    builder.set_input_types(*[input_types[n] for n in input_names])
    builder.set_outputs(*[resolve(n) for n in output_names])
    conf = builder.build()
    net = ComputationGraph(conf).init(device=device)

    with _open(path) as f:
        for name in keras_names:
            ws = _weight_arrays(f, name)
            if not ws:
                continue
            v = conf.vertices[name]
            p = dict(net.params.get(name, {}))
            st = dict(net.state.get(name, {}))
            new_p, new_st = _layer_param_update(
                v.layer, p, st, ws, dim_ordering, v.preprocessor)
            net.params[name] = new_p
            if new_st is not None:
                net.state[name] = new_st
    return net


def import_keras_sequential_model_and_weights(
        path, quantize=None, device=None) -> MultiLayerNetwork:
    with _open(path) as f:
        config = _model_config(f)
    if config["class_name"] != "Sequential":
        raise ValueError("Not a Sequential model; use "
                         "import_keras_model_and_weights")
    return _maybe_quantize(_import_sequential(path, config, device),
                           quantize)


def _import_sequential(path, config: dict, device=None
                       ) -> MultiLayerNetwork:
    layer_dicts = config["config"]
    if isinstance(layer_dicts, dict):  # Keras 2 nests under "layers"
        layer_dicts = layer_dicts["layers"]
    translator = KerasLayerTranslator()

    dim_ordering = "tf"
    for ld in layer_dicts:
        d = _cfg(ld).get("dim_ordering") or _cfg(ld).get("data_format")
        if d:
            dim_ordering = {"channels_first": "th",
                            "channels_last": "tf"}.get(d, d)
            break

    native_layers = []
    keras_names = []  # keras layer name per native layer (for weights)
    input_type = None
    n_real = sum(1 for l in layer_dicts
                 if l["class_name"] not in ("InputLayer", "Flatten"))
    seen_real = 0
    for i, ld in enumerate(layer_dicts):
        if input_type is None:
            it = translator.input_type(ld, dim_ordering)
            if it is not None:
                input_type = it
        t = translator.translate(
            ld, is_last=(seen_real + 1 == n_real
                         and ld["class_name"] not in ("InputLayer",
                                                      "Flatten")))
        if t is None or t == "flatten":
            continue
        seen_real += 1
        native_layers.append(t)
        keras_names.append(_cfg(ld).get("name") or ld.get("name")
                           or f"layer_{i}")

    if input_type is None:
        raise ValueError("Could not infer input shape "
                         "(no batch_input_shape in first layer)")
    conf = (NeuralNetConfiguration.builder()
            .seed(12345)
            .list(*native_layers)
            .set_input_type(input_type)
            .build())
    net = MultiLayerNetwork(conf).init(device=device)
    _copy_weights(path, net, keras_names, dim_ordering)
    return net


def _weight_arrays(f, keras_name: str):
    """Ordered weight arrays for one keras layer from the model_weights
    group (reference: KerasModel weight loading via 'weight_names' attr)."""
    root = f["model_weights"] if "model_weights" in f else f
    if keras_name not in root:
        return []
    g = root[keras_name]
    names = g.attrs.get("weight_names")
    out = []
    if names is not None:
        for n in names:
            n = n.decode() if isinstance(n, bytes) else str(n)
            out.append(np.asarray(g[n]))
    else:
        def visit(_, obj):
            if hasattr(obj, "shape") and hasattr(obj, "dtype"):
                out.append(np.asarray(obj))
        g.visititems(visit)
    return out


def _layer_param_update(layer, p, st, ws, dim_ordering, preprocessor):
    """Apply one keras layer's weight arrays ``ws`` to its native param
    dict ``p`` (+ state ``st`` for BN running stats). Shared by the
    sequential (flat-indexed) and functional (vertex-named) importers.
    Returns (new_params, new_state_or_None)."""
    new_st = None
    if isinstance(layer, ConvolutionLayer):
        k, b = ws[0], (ws[1] if len(ws) > 1 else None)
        if k.ndim == 4 and dim_ordering == "th":
            # [out, in, kh, kw] true-conv -> HWIO cross-correlation
            k = np.transpose(k, (2, 3, 1, 0))[::-1, ::-1]
        p["W"] = _as(k, p["W"])
        if b is not None:
            p["b"] = _as(b, p["b"])
    elif isinstance(layer, (DenseLayer, OutputLayer)):
        W, b = ws[0], (ws[1] if len(ws) > 1 else None)
        if W.shape != tuple(p["W"].shape):
            raise ValueError(
                f"Dense weight shape {W.shape} != expected "
                f"{tuple(p['W'].shape)}")
        if (dim_ordering == "th" and preprocessor is not None
                and hasattr(preprocessor, "channels")):
            # keras th Flatten emitted (c,h,w) order; our flatten is
            # NHWC -> permute rows (reference:
            # TensorFlowCnnToFeedForwardPreProcessor inverse)
            h_, w_, c_ = (preprocessor.height, preprocessor.width,
                          preprocessor.channels)
            perm = np.arange(c_ * h_ * w_).reshape(
                c_, h_, w_).transpose(1, 2, 0).ravel()
            W = W[perm]
        p["W"] = _as(W, p["W"])
        if b is not None:
            p["b"] = _as(b, p["b"])
    elif isinstance(layer, BatchNormalization):
        # keras order: gamma, beta, moving_mean, moving_var
        for name, w in zip(["gamma", "beta"], ws[:2]):
            if name in p:
                p[name] = _as(w, p[name])
        if len(ws) >= 4:
            new_st = dict(st)
            new_st["mean"] = _as(ws[2], st["mean"])
            new_st["var"] = _as(ws[3], st["var"])
    elif isinstance(layer, LSTM):
        p.update(_lstm_weights(ws, layer, p))
    elif isinstance(layer, EmbeddingLayer):
        p["W"] = _as(ws[0], p["W"])
    return p, new_st


def _copy_weights(path, net, keras_names, dim_ordering):
    with _open(path) as f:
        for i, (layer, kname) in enumerate(zip(net.conf.layers, keras_names)):
            ws = _weight_arrays(f, kname)
            if not ws:
                continue
            key = str(i)
            p, new_st = _layer_param_update(
                layer, dict(net.params[key]), dict(net.state.get(key, {})),
                ws, dim_ordering, net.conf.preprocessors.get(i))
            net.params[key] = p
            if new_st is not None:
                net.state[key] = new_st


def _lstm_weights(ws, layer, p):
    """Keras LSTM weights -> native {W, RW, b} with (i,f,c,o)->(i,f,o,g)
    block permutation. Handles Keras-2 packed (kernel, recurrent, bias) and
    Keras-1 per-gate 12-array layouts."""
    H = layer.n_out

    def permute(m, axis):
        blocks = np.split(m, 4, axis=axis)  # i, f, c, o
        return np.concatenate([blocks[0], blocks[1], blocks[3], blocks[2]],
                              axis=axis)

    if len(ws) == 3:
        W, RW, b = ws
        return {"W": _as(permute(W, 1), p["W"]),
                "RW": _as(permute(RW, 1), p["RW"]),
                "b": _as(permute(b, 0), p["b"])}
    if len(ws) == 12:
        # keras1 order: W_i U_i b_i, W_c U_c b_c, W_f U_f b_f, W_o U_o b_o
        Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo, bo = ws
        W = np.concatenate([Wi, Wf, Wo, Wc], axis=1)
        RW = np.concatenate([Ui, Uf, Uo, Uc], axis=1)
        b = np.concatenate([bi, bf, bo, bc], axis=0)
        return {"W": _as(W, p["W"]),
                "RW": _as(RW, p["RW"]),
                "b": _as(b, p["b"])}
    raise ValueError(f"Unexpected LSTM weight count {len(ws)}")
