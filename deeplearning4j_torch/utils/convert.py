"""Load the JAX package's parameters and updater state into the port.

``params_from_jax`` takes the reference net's parameters as numpy arrays —
``{vertex: {name: ndarray}}``, as ``jax.device_get(net.params)`` gives them —
and loads them into a port ``ComputationGraph`` unchanged: the layouts are
the same on both sides (Dense ``W`` is ``[n_in, n_out]``), so no transpose
or reorder is needed. ``updater_state_from_jax`` does the same for the
optimizer slots (``{slot: {vertex: {name: ndarray}}}``, Adam's ``m`` and
``v``), so a run can continue from a JAX-trained state. Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _load_tree(tree: dict, ours: dict) -> dict:
    """``tree`` as tensors on the devices and dtypes of ``ours``, after
    checking its vertices, names and shapes against ``ours``."""
    if set(tree) != set(ours):
        raise ValueError(f"vertex sets differ: only in the reference "
                         f"{sorted(set(tree) - set(ours))}, only in the "
                         f"port {sorted(set(ours) - set(tree))}")
    loaded = {}
    for vname, p in tree.items():
        if set(p) != set(ours[vname]):
            raise ValueError(f"vertex '{vname}': parameters "
                             f"{sorted(p)} != {sorted(ours[vname])}")
        loaded[vname] = {}
        for pname, a in p.items():
            a = np.asarray(a)
            ref = ours[vname][pname]
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"{vname}.{pname}: shape {a.shape} != "
                                 f"{tuple(ref.shape)}")
            loaded[vname][pname] = torch.from_numpy(np.array(a)).to(
                device=ref.device, dtype=ref.dtype)
    return loaded


def _to_numpy(tree: dict) -> dict:
    return {v: {k: t.detach().cpu().numpy() for k, t in p.items()}
            for v, p in tree.items()}


def params_from_jax(params: dict, net):
    """Check every vertex and parameter against ``net``'s own and replace
    ``net.params`` with ``params`` on the net's device. Returns ``net``."""
    net.params = _load_tree(params, net.params)
    return net


def params_to_numpy(net) -> dict:
    """The port's parameters as ``{vertex: {name: ndarray}}`` (the inverse
    of ``params_from_jax``)."""
    return _to_numpy(net.params)


def updater_state_from_jax(state: dict, net, iteration=None):
    """Check the reference's updater state against the slots and shapes of
    ``net.updater_state`` and replace it, on the net's device. With
    ``iteration``, also set ``net.iteration`` (Adam's step count), so
    training continues where the reference stopped. Returns ``net``."""
    ours = net.updater_state
    if set(state) != set(ours):
        raise ValueError(f"updater slots differ: reference {sorted(state)}, "
                         f"port {sorted(ours)}")
    loaded = {}
    for slot, tree in state.items():
        try:
            loaded[slot] = _load_tree(tree, ours[slot])
        except ValueError as e:
            raise ValueError(f"updater slot '{slot}': {e}") from None
    net.updater_state = loaded
    if iteration is not None:
        net.iteration = int(iteration)
    return net


def updater_state_to_numpy(net) -> dict:
    """The port's updater state as ``{slot: {vertex: {name: ndarray}}}``
    (the inverse of ``updater_state_from_jax``)."""
    return {slot: _to_numpy(tree) for slot, tree in net.updater_state.items()}
