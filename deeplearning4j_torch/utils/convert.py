"""Load the JAX package's parameters and updater state into the port.

``params_from_jax`` takes the reference net's parameters as numpy arrays —
``{vertex: {name: ndarray}}`` for a graph, ``{layer index: {name:
ndarray}}`` for a MultiLayerNetwork, as ``jax.device_get(net.params)``
gives them — and loads them into the port's net unchanged: the layouts are
the same on both sides (Dense ``W`` is ``[n_in, n_out]``, convolution
kernels HWIO, the mixture-of-experts leaves ``Wg, W1, b1, W2, b2``
stacked on the expert axis), so no transpose or reorder is needed. A
graph's tree is keyed by vertex name and holds an empty dict for each
parameterless vertex, on both sides. ``state_from_jax`` loads the layer
state the same way (batch norm's running ``mean``/``var``, the center-loss
centers) and ``updater_state_from_jax`` the optimizer slots (``{slot:
{vertex: {name: ndarray}}}``, Adam's ``m`` and ``v``), so a run can
continue from a JAX-trained state. A quantized
reference tree (``quantize_params``/``quantize_net``: int8 codes with
``"<name>_scale"`` f32 siblings) loads as it is, codes int8 and scales f32,
whether the port net is quantized already or not. Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.optimize.quantize import SCALE_SUFFIX


def _load_tree(tree: dict, ours: dict) -> dict:
    """``tree`` as tensors on the devices and dtypes of ``ours``, after
    checking its vertices, names and shapes against ``ours``. A weight that
    carries a ``"<name>_scale"`` sibling in ``tree`` but not in ``ours``
    loads as int8 codes (which it must be) beside its f32 scale of one
    entry per output channel."""
    if set(tree) != set(ours):
        raise ValueError(f"vertex sets differ: only in the reference "
                         f"{sorted(set(tree) - set(ours))}, only in the "
                         f"port {sorted(set(ours) - set(tree))}")
    loaded = {}
    for vname, p in tree.items():
        mine = ours[vname]
        scales = {k for k in p if k.endswith(SCALE_SUFFIX) and k not in mine
                  and k[:-len(SCALE_SUFFIX)] in mine}
        if set(p) - scales != set(mine):
            raise ValueError(f"vertex '{vname}': parameters "
                             f"{sorted(p)} != {sorted(mine)}")
        loaded[vname] = {}
        for pname, a in p.items():
            a = np.asarray(a)
            if pname in scales:          # a dequant scale: f32 [out]
                ref = mine[pname[:-len(SCALE_SUFFIX)]]
                shape, dtype = tuple(ref.shape[-1:]), torch.float32
            elif pname + SCALE_SUFFIX in scales:     # its int8 codes
                ref = mine[pname]
                shape, dtype = tuple(ref.shape), torch.int8
                if a.dtype != np.int8:
                    raise ValueError(f"{vname}.{pname}: a scaled weight "
                                     f"must be int8 codes, got {a.dtype}")
            else:
                ref = mine[pname]
                shape, dtype = tuple(ref.shape), ref.dtype
            if tuple(a.shape) != shape:
                raise ValueError(f"{vname}.{pname}: shape {a.shape} != "
                                 f"{shape}")
            loaded[vname][pname] = torch.from_numpy(np.array(a)).to(
                device=ref.device, dtype=dtype)
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


def state_from_jax(state: dict, net):
    """Check the reference's layer state (``jax.device_get(net.state)``)
    against ``net.state`` and replace it, on the net's device; the carry
    entries the port keeps out of the layer state (``nn/network.py::
    CARRY_KEYS``) are dropped. Returns ``net``."""
    from deeplearning4j_torch.nn.network import CARRY_KEYS

    tree = {v: {k: a for k, a in p.items() if k not in CARRY_KEYS}
            for v, p in state.items()}
    net.state = _load_tree(tree, net.state)
    return net


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
