"""ComputationGraph (port of the inference parts of
``deeplearning4j_tpu/nn/graph.py``): parameters, the topological forward with
an optional serving carry, ``output()`` and ``_stream_layers``.

Params keep the JAX pytree shape, ``{vertex_name: {param: Tensor}}``, so the
reference's weights load unchanged (``utils/convert.py``). Training (``fit``,
the updater, the fused step) belongs to the training slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)

#: state keys that belong to the serving carry rather than the layer state
_CARRY_KEYS = ("cache_pos", "kpages", "vpages", "block_table", "kscales",
               "vscales")


def _as_list(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.params: dict = {}
        self.state: dict = {}
        self.device: Optional[torch.device] = None

    def init(self, params: Optional[dict] = None, *,
             device=None) -> "ComputationGraph":
        """Draw the weights (xavier from a CPU ``torch.Generator`` seeded
        with ``conf.seed``, so the draw is the same on every device) or take
        ``params``, and home them on ``device`` (CUDA unless the caller
        passes another device)."""
        self.device = resolve_device(device)
        dtype = getattr(torch, self.conf.dtype)
        if params is None:
            gen = torch.Generator(device="cpu").manual_seed(self.conf.seed)
            params = {name: self.conf.vertices[name].init_params(
                gen, dtype, "cpu") for name in self.conf.topo_order}
        self.params = {name: {k: torch.as_tensor(t).to(self.device)
                              for k, t in p.items()}
                       for name, p in params.items()}
        self.state = {name: {} for name in self.conf.topo_order}
        return self

    def _forward(self, params, state, inputs, masks, *, carry=None):
        """Traverse the DAG in topo order. Returns (outputs list,
        new_carry)."""
        conf = self.conf
        acts = dict(zip(conf.network_inputs, inputs))
        act_masks = dict(zip(conf.network_inputs,
                             masks or [None] * len(inputs)))
        new_carry: dict = {}
        for name in conf.topo_order:
            v = conf.vertices[name]
            v_in = [acts[k] for k in conf.vertex_inputs[name]]
            v_masks = [act_masks.get(k) for k in conf.vertex_inputs[name]]
            vertex_state = dict(state.get(name, {}))
            if carry is not None and name in carry:
                vertex_state.update(carry[name])
            out, ns = v.forward(params.get(name, {}), vertex_state, v_in,
                                masks=v_masks)
            c = {k: t for k, t in ns.items() if k in _CARRY_KEYS}
            if c:
                new_carry[name] = c
            acts[name] = out
            act_masks[name] = v.feed_forward_mask(v_masks)
        return [acts[o] for o in conf.network_outputs], new_carry

    def _as_tensor(self, a, dtype=None):
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        return t.to(device=self.device, dtype=dtype or t.dtype)

    @torch.inference_mode()
    def output(self, *inputs, masks=None):
        """Output-vertex activations; a single output returns the bare
        tensor. Inputs may be numpy arrays or tensors; they are moved to the
        net's device."""
        dtype = getattr(torch, self.conf.dtype)
        xs = [self._as_tensor(a, dtype) for a in inputs]
        ms = ([None if m is None else self._as_tensor(m, torch.float32)
               for m in _as_list(masks)] if masks is not None
              else [None] * len(xs))
        outs, _ = self._forward(self.params, self.state, xs, ms)
        return outs[0] if len(outs) == 1 else outs

    def _stream_layers(self):
        """(name, layer) pairs of the layers that carry serving state (KV
        pages or a position counter), keyed as the serving carry is."""
        for name, v in self.conf.vertices.items():
            layer = getattr(v, "layer", None)
            if layer is not None and layer.STREAMS:
                yield name, layer
