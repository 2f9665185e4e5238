"""Model zips (port of ``deeplearning4j_tpu/utils/model_serializer.py``):
``save_model``, ``load_model`` and ``net_from_conf``.

The zip is the contract between the two packages. Its entries:

- ``configuration.json``: the ``@class``-tagged configuration JSON
  (``utils/serde.py``);
- ``coefficients.bin``: the flat parameter vector (``utils/pytree.py``
  order: a MultiLayerNetwork's layers by index or a graph's vertices in
  topological order, then each one's ``param_order()``) as little-endian
  f32;
- ``metadata.json``: format version, model type, ``iteration``, ``epoch``
  and the parameter count;
- ``state.npz``: the layer state tree, keys ``layer/name`` (batch norm's
  ``3/mean`` and ``3/var``);
- ``updaterState.bin``: the updater state as an npz, keys
  ``slot/layer/name`` (Adam's ``m`` and ``v``).

A zip written here loads in the JAX package and the reverse, for
MultiLayerNetworks and ComputationGraphs; the coefficients of a round trip
are byte for byte the same.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.utils import serde


def _state_to_npz(tree) -> bytes:
    """A nested dict of tensors as npz with ``/``-joined keys (16-bit
    tensors widened to f32; empty dicts leave no key)."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            t = torch.as_tensor(node).detach().cpu()
            if t.dtype in (torch.bfloat16, torch.float16):
                t = t.float()
            flat[prefix] = t.numpy()

    rec("", tree)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _npz_to_state(data: bytes) -> dict:
    out: dict = {}
    with np.load(io.BytesIO(data)) as npz:
        for key in npz.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    return out


def _merge_into(template, loaded, where: str = ""):
    """Overlay the loaded leaves onto a freshly initialised template tree,
    as tensors of the template leaves' dtype and device (npz cannot hold
    empty dicts, so the template keeps the tree's structure). A loaded
    leaf of another shape raises."""
    if not isinstance(template, dict):
        if loaded is None:
            return template
        a = np.asarray(loaded)
        if tuple(a.shape) != tuple(template.shape):
            raise ValueError(f"{where}: shape {a.shape} in the zip, "
                             f"{tuple(template.shape)} in the net")
        return torch.from_numpy(np.array(a)).to(device=template.device,
                                                dtype=template.dtype)
    return {k: _merge_into(v, loaded.get(k) if isinstance(loaded, dict)
                           else None, f"{where}/{k}" if where else k)
            for k, v in template.items()}


def save_model(net, path: str, save_updater: bool = True) -> None:
    """Write a net to a model zip the JAX package reads.

    A quantized net (``optimize/quantize.py``: int8 codes with
    ``"<name>_scale"`` siblings) raises ``ValueError``: the zip's flat f32
    coefficients follow ``param_order``, which has no place for the scales,
    so they would be dropped and the codes written as f32 (what the JAX
    package's ``save_model`` does without a word). Save the source net and
    quantize after loading."""
    from deeplearning4j_torch.optimize.quantize import is_quantized

    if is_quantized(net.params):
        raise ValueError(
            "save_model: the net's params are int8-quantized (they carry "
            "'*_scale' siblings), which the zip's flat f32 coefficients "
            "cannot hold; save the unquantized net and quantize_net() it "
            "after load_model()")
    flat = net.params_flat()
    meta = {
        "format_version": 1,
        "model_type": type(net).__name__,
        "iteration": int(net.iteration),
        "epoch": int(getattr(net, "epoch", 0)),
        "num_params": int(flat.size),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", net.conf.to_json())
        zf.writestr("coefficients.bin", flat.astype("<f4").tobytes())
        zf.writestr("metadata.json", json.dumps(meta))
        zf.writestr("state.npz", _state_to_npz(net.state))
        if save_updater and net.updater_state:
            zf.writestr("updaterState.bin", _state_to_npz(net.updater_state))


def _net_class(conf):
    if isinstance(conf, ComputationGraphConfiguration):
        conf.finalize()
        return ComputationGraph
    if isinstance(conf, MultiLayerConfiguration):
        return MultiLayerNetwork
    raise ValueError(f"configuration.json holds a {type(conf).__name__}, "
                     "not a network configuration")


def net_from_conf(conf, *, device=None):
    """The initialised network (freshly drawn weights) of the right class
    for a deserialized configuration, on ``device`` (CUDA unless the
    caller asks for another device)."""
    return _net_class(conf)(conf).init(device=device)


def load_model(path: str, load_updater: bool = True, *, device=None):
    """Restore a model zip into an initialised network with its
    parameters, state, updater state, ``iteration`` and ``epoch``, on
    ``device`` (CUDA unless the caller asks for another device)."""
    with zipfile.ZipFile(path, "r") as zf:
        names = zf.namelist()
        raw = json.loads(zf.read("configuration.json").decode())
        meta = json.loads(zf.read("metadata.json").decode())
        coeff = np.frombuffer(zf.read("coefficients.bin"), "<f4").copy()
        state = (_npz_to_state(zf.read("state.npz"))
                 if "state.npz" in names else {})
        upd = (_npz_to_state(zf.read("updaterState.bin"))
               if load_updater and "updaterState.bin" in names else None)
    conf = serde.from_jsonable(raw)
    try:
        cls = _net_class(conf)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    net = cls(conf)
    # the zip's weights replace any draw, so none is made (and an init
    # scheme the port cannot draw does not stop the load)
    dtype = getattr(torch, conf.dtype)
    net.init({k: o.init_params(None, dtype, "cpu")
              for k, o in net._param_owners().items()}, device=device)
    net.set_params_flat(coeff)
    if state:
        net.state = _merge_into(net.state, state, "state")
    if upd is not None:
        net.updater_state = _merge_into(net.updater_state, upd,
                                        "updaterState")
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    return net
