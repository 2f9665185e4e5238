"""Load the JAX package's parameters into the port.

``params_from_jax`` takes the reference net's parameters as numpy arrays —
``{vertex: {name: ndarray}}``, as ``jax.device_get(net.params)`` gives them —
and loads them into a port ``ComputationGraph`` unchanged: the layouts are
the same on both sides (Dense ``W`` is ``[n_in, n_out]``), so no transpose
or reorder is needed. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict, net):
    """Check every vertex and parameter against ``net``'s own and replace
    ``net.params`` with ``params`` on the net's device. Returns ``net``."""
    ours = net.params
    if set(params) != set(ours):
        raise ValueError(f"vertex sets differ: only in the reference "
                         f"{sorted(set(params) - set(ours))}, only in the "
                         f"port {sorted(set(ours) - set(params))}")
    loaded = {}
    for vname, p in params.items():
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
    net.params = loaded
    return net


def params_to_numpy(net) -> dict:
    """The port's parameters as ``{vertex: {name: ndarray}}`` (the inverse
    of ``params_from_jax``)."""
    return {v: {k: t.detach().cpu().numpy() for k, t in p.items()}
            for v, p in net.params.items()}
