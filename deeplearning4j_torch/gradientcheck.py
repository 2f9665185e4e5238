"""Finite-difference gradient checking (port of
``deeplearning4j_tpu/gradientcheck.py``).

Each parameter's central difference ``(C(w + eps) - C(w - eps)) / (2 eps)``
is held against the autograd gradient of the same loss plus the closed-form
L1/L2 gradient the train step adds (``nn/regularization.py``), each
difference taken by nudging one entry of a working copy in place; a
parameter
fails where the relative error ``|a - n| / max(|a|, |n|)`` exceeds
``max_rel_error`` and the absolute error exceeds ``min_abs_error``. The
parameters are walked in the flat order of ``utils/pytree.py`` (the JAX
package walks a graph's in ``ravel_pytree``'s sorted order; only
``subset``'s draw depends on the order). Run it on a float64 net.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch.nn.regularization import add_regularization_grads
from deeplearning4j_torch.optimize.fused_fit import value_and_grad
from deeplearning4j_torch.utils.pytree import flat_slots, flatten_params


def check_gradients(net, x, y, input_mask=None, label_mask=None, *,
                    eps: float = 1e-6, max_rel_error: float = 1e-5,
                    min_abs_error: float = 1e-8,
                    subset: Optional[int] = None, seed: int = 0,
                    train: bool = True, verbose: bool = False) -> bool:
    """True when every checked parameter's gradient passes. ``train``
    runs the training forward with no key (batch statistics, no dropout);
    ``subset`` checks that many parameters drawn with ``seed``."""
    xs, ys, im, lm = net._batch(x, y, input_mask, label_mask)
    owners = net._param_owners()
    params0 = net.params
    _, grads = value_and_grad(net, params0, net.state, xs, ys, im, lm,
                              train=train)
    with torch.no_grad():
        grads = add_regularization_grads(net, params0, grads)
    analytic = flatten_params(grads, owners).astype(np.float64)
    # one working copy whose leaves are nudged in place, entry by entry
    work = {v: {k: t.detach().clone() for k, t in p.items()}
            for v, p in params0.items()}
    leaves = [work[v][p].view(-1) for v, p in flat_slots(work, owners)]
    starts = np.cumsum([0] + [t.numel() for t in leaves])
    n = int(starts[-1])

    def loss_at(leaf, j, value):
        leaf[j] = value
        with torch.no_grad():
            loss, _ = net._loss(work, net.state, xs, ys, im, lm,
                                train=train, rng=None)
        return float(loss)

    if subset is not None and subset < n:
        idxs = np.random.default_rng(seed).choice(n, subset, replace=False)
    else:
        idxs = np.arange(n)
    n_fail = 0
    max_err = 0.0
    for i in idxs:
        li = int(np.searchsorted(starts, i, side="right")) - 1
        leaf, j = leaves[li], int(i - starts[li])
        w = float(leaf[j])
        numeric = (loss_at(leaf, j, w + eps) - loss_at(leaf, j, w - eps)) \
            / (2.0 * eps)
        leaf[j] = w
        a = analytic[i]
        denom = max(abs(a), abs(numeric))
        rel = abs(a - numeric) / denom if denom > 0 else 0.0
        max_err = max(max_err, rel)
        if rel > max_rel_error and abs(a - numeric) > min_abs_error:
            n_fail += 1
            if verbose:
                print(f"param {i}: analytic={a:.8g} numeric={numeric:.8g} "
                      f"rel={rel:.3g}")
    if verbose:
        print(f"checked {len(idxs)}/{n} params, max rel error {max_err:.3g}, "
              f"{n_fail} failures")
    return n_fail == 0
