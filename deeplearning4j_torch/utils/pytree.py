"""The flat parameter view (port of ``deeplearning4j_tpu/utils/pytree.py``):
every parameter of a net in one vector, its owners in the net's order (a
MultiLayerNetwork's layers by integer index, a graph's vertices in
topological order; ``Network._param_owners``) and each owner's parameters
in its ``param_order()``. ``params_flat`` and the model zip's
``coefficients.bin`` both use this order, so a zip's coefficients are
exchangeable between the two packages."""

from __future__ import annotations

import numpy as np
import torch


def flat_slots(params: dict, owners: dict) -> list:
    """(owner key, param) pairs in the flat-vector order."""
    return [(key, p) for key, owner in owners.items()
            for p in owner.param_order() if p in params.get(key, {})]


def flatten_params(params: dict, owners: dict) -> np.ndarray:
    """``{key: {name: Tensor}}`` -> one 1-D numpy vector. 16-bit leaves
    are widened to f32 (exactly); a JAX bf16 net's vector is bf16, the same
    values."""
    chunks = []
    for v, p in flat_slots(params, owners):
        t = params[v][p].detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        chunks.append(t.numpy().ravel())
    if not chunks:
        return np.zeros((0,), np.float32)
    return np.concatenate(chunks)


def unflatten_params(flat, template: dict, owners: dict) -> dict:
    """The inverse of ``flatten_params``: shapes, dtypes and devices from
    ``template`` (values rounded to a 16-bit leaf's dtype to nearest
    even, as JAX's ``asarray`` rounds them)."""
    flat = np.asarray(flat).ravel()
    slots = flat_slots(template, owners)
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
