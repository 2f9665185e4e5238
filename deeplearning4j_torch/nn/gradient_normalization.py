"""Gradient normalization and clipping between backprop and the updater
(port of ``deeplearning4j_tpu/nn/gradient_normalization.py``).

Per layer, over the layer's whole gradient ("per layer") or over each
named parameter ("per param type"). Every reduction and select stays on
the gradients' device: no host sync.
"""

from __future__ import annotations

import torch

MODES = ("none", "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
         "clip_element_wise_absolute_value", "clip_l2_per_layer",
         "clip_l2_per_param_type")

# guards division by an exactly-zero norm (all-zero gradients), as JAX's
_EPS = 1e-30


def _global_l2(g: dict):
    total = None
    for v in g.values():
        s = torch.square(v).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(l2, threshold):
    return torch.where(l2 > threshold,
                       threshold / torch.clamp(l2, min=_EPS),
                       torch.ones_like(l2))


def _apply_one(mode: str, threshold: float, g: dict) -> dict:
    if mode == "renormalize_l2_per_layer":
        l2 = torch.clamp(_global_l2(g), min=_EPS)
        return {k: v / l2 for k, v in g.items()}
    if mode == "renormalize_l2_per_param_type":
        return {k: v / torch.clamp(torch.linalg.vector_norm(v), min=_EPS)
                for k, v in g.items()}
    if mode == "clip_element_wise_absolute_value":
        return {k: torch.clamp(v, -threshold, threshold)
                for k, v in g.items()}
    if mode == "clip_l2_per_layer":
        scale = _clip_scale(_global_l2(g), threshold)
        return {k: v * scale.to(v.dtype) for k, v in g.items()}
    if mode == "clip_l2_per_param_type":
        return {k: v * _clip_scale(torch.linalg.vector_norm(v),
                                   threshold).to(v.dtype)
                for k, v in g.items()}
    raise ValueError(f"Unknown gradient_normalization '{mode}'; "
                     f"choose one of {MODES}")


def apply_gradient_normalization(layer_map: dict, grads: dict) -> dict:
    """Each layer's configured mode over its gradient sub-tree
    (``layer_map``: {vertex name: layer}); layers with mode None or "none"
    pass through untouched."""
    out = dict(grads)
    for key, layer in layer_map.items():
        mode = getattr(layer, "gradient_normalization", None)
        if mode is None or mode == "none" or key not in grads:
            continue
        if not grads[key]:
            continue
        threshold = getattr(layer, "gradient_normalization_threshold", None)
        threshold = 1.0 if threshold is None else float(threshold)
        out[key] = _apply_one(mode, threshold, grads[key])
    return out


def layer_map_for(net) -> dict:
    """The gradient-tree-keyed layer map of a net (``_param_owners``):
    each layer, whose ``gradient_normalization`` fields the build filled
    from the global configuration where the layer left them None."""
    return dict(net._param_owners())
