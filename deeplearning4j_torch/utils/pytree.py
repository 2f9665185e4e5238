"""The flat parameter view (port of the graph order of
``deeplearning4j_tpu/utils/pytree.py::flatten_params`` and
``nn/graph.py::params_flat``): every parameter of a graph in one vector,
vertices in topological order and each vertex's parameters in its
``param_order()``. ``ComputationGraph.params_flat`` and the model zip's
``coefficients.bin`` both use this order, so a zip's coefficients are
exchangeable between the two packages."""

from __future__ import annotations

import numpy as np
import torch


def flat_slots(params: dict, conf) -> list:
    """(vertex, param) pairs in the flat-vector order."""
    return [(name, p) for name in conf.topo_order
            for p in conf.vertices[name].param_order()
            if p in params.get(name, {})]


def flatten_params(params: dict, conf) -> np.ndarray:
    """``{vertex: {name: Tensor}}`` -> one 1-D numpy vector. 16-bit leaves
    are widened to f32 (exactly); a JAX bf16 net's vector is bf16, the same
    values."""
    chunks = []
    for v, p in flat_slots(params, conf):
        t = params[v][p].detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        chunks.append(t.numpy().ravel())
    if not chunks:
        return np.zeros((0,), np.float32)
    return np.concatenate(chunks)


def unflatten_params(flat, template: dict, conf) -> dict:
    """The inverse of ``flatten_params``: shapes, dtypes and devices from
    ``template`` (values rounded to a 16-bit leaf's dtype to nearest
    even, as JAX's ``asarray`` rounds them)."""
    flat = np.asarray(flat).ravel()
    slots = flat_slots(template, conf)
    n_all = sum(template[v][p].numel() for v, p in slots)
    if n_all != flat.size:
        raise ValueError(f"Flat param size {flat.size} != expected {n_all}")
    out = {name: dict(p) for name, p in template.items()}
    off = 0
    for v, p in slots:
        tmpl = template[v][p]
        n = tmpl.numel()
        out[v][p] = torch.from_numpy(np.array(
            flat[off:off + n]).reshape(tuple(tmpl.shape))).to(
                device=tmpl.device, dtype=tmpl.dtype)
        off += n
    return out
