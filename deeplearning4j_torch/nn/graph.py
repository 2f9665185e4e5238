"""ComputationGraph (port of ``deeplearning4j_tpu/nn/graph.py``): parameters,
the topological forward with an optional serving carry, ``output()``,
streaming inference (``rnn_time_step`` over the attention layers' dense KV
caches), ``_stream_layers``, and training: ``_loss``, ``do_step``,
``fit``, ``score`` and the flat-parameter plumbing.

Params keep the JAX pytree shape, ``{vertex_name: {param: Tensor}}``, so the
reference's weights load unchanged (``utils/convert.py``); the updater state
is a dict of such trees. One training step is ``build_step_core``
(``optimize/fused_fit.py``): autograd of ``_loss``, the updater, then
``params - steps``.

``fit`` in this port is JAX's ``fit(..., fused_steps=1,
health_guard=None)``: the fused K-step driver and the numerical-health
guard are ROADMAP §A5, TBPTT, layer-wise pretraining, ``compute_dtype`` and
MultiDataSet are not ported (ROADMAP §A6) and raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_torch.utils.pytree import (flatten_params,
                                               unflatten_params)

#: state keys that belong to the streaming or serving carry rather than the
#: layer state: dense KV caches (``rnn_time_step``) and paged pools
_CARRY_KEYS = ("cache_pos", "kcache", "vcache", "kscale", "vscale", "kpages",
               "vpages", "block_table", "kscales", "vscales")


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
        self.updater_state: dict = {}
        self.iteration = 0
        self.epoch = 0
        # the last step's loss, a device tensor: reading it is the sync
        self.score_value = float("nan")
        self.device: Optional[torch.device] = None
        self._step = None
        self._rnn_state: Optional[dict] = None
        self._stream_pos = 0              # tokens consumed this stream
        self._stream_capacity = None      # min attention max_cache, if any

    def init(self, params: Optional[dict] = None, *,
             device=None) -> "ComputationGraph":
        """Draw the weights (xavier from a CPU ``torch.Generator`` seeded
        with ``conf.seed``, so the draw is the same on every device) or take
        ``params``, and home them on ``device`` (CUDA unless the caller
        passes another device). The updater state starts from
        ``conf.updater.init``."""
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
        self.updater_state = self.conf.updater.init(self.params)
        return self

    def _forward(self, params, state, inputs, masks, *, carry=None,
                 collect_loss_inputs=False):
        """Traverse the DAG in topo order. Returns (outputs list, new_carry,
        output masks list, loss_inputs), where ``loss_inputs[name]`` is the
        input of each output vertex with a loss head (what its loss
        consumes), filled when ``collect_loss_inputs``."""
        conf = self.conf
        if conf.compute_dtype is not None:
            raise NotImplementedError(
                f"compute_dtype={conf.compute_dtype!r}: mixed precision is "
                "not ported yet (ROADMAP §A6)")
        acts = dict(zip(conf.network_inputs, inputs))
        act_masks = dict(zip(conf.network_inputs,
                             masks or [None] * len(inputs)))
        new_carry: dict = {}
        loss_inputs: dict = {}
        for name in conf.topo_order:
            v = conf.vertices[name]
            v_in = [acts[k] for k in conf.vertex_inputs[name]]
            v_masks = [act_masks.get(k) for k in conf.vertex_inputs[name]]
            if (collect_loss_inputs and name in conf.network_outputs
                    and hasattr(getattr(v, "layer", None),
                                "compute_loss_per_example")):
                loss_inputs[name] = v_in[0]
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
        outs = [acts[o] for o in conf.network_outputs]
        out_masks = [act_masks.get(o) for o in conf.network_outputs]
        return outs, new_carry, out_masks, loss_inputs

    def _as_tensor(self, a, dtype=None):
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def _batch(self, x, y, input_mask, label_mask):
        """Inputs, labels and masks as lists of tensors on the net's device
        (masks f32; a list of masks that are all None becomes None)."""
        dtype = getattr(torch, self.conf.dtype)

        def masks(ms):
            ms = _as_list(ms)
            if ms is None or all(m is None for m in ms):
                return None
            return [None if m is None else self._as_tensor(m, torch.float32)
                    for m in ms]

        return ([self._as_tensor(a, dtype) for a in _as_list(x)],
                [self._as_tensor(a, dtype) for a in _as_list(y)],
                masks(input_mask), masks(label_mask))

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
        outs, _, _, _ = self._forward(self.params, self.state, xs, ms)
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------------- training
    def _loss(self, params, state, x, y, input_mask, label_mask):
        """The training loss (JAX ``_loss``): each output vertex's per-example
        loss, averaged over its label mask (else the propagated output mask,
        else a plain mean), summed over the outputs. Returns a 0-d tensor."""
        conf = self.conf
        xs, ys = _as_list(x), _as_list(y)
        ims = _as_list(input_mask) or [None] * len(xs)
        lms = _as_list(label_mask) or [None] * len(ys)
        _, _, out_masks, loss_inputs = self._forward(
            params, state, xs, ims, collect_loss_inputs=True)
        total = 0.0
        for j, name in enumerate(conf.network_outputs):
            if name not in loss_inputs:
                raise ValueError(f"Output vertex '{name}' has no loss head")
            per_ex = conf.vertices[name].layer.compute_loss_per_example(
                params[name], loss_inputs[name], ys[j])
            lm = lms[j] if lms[j] is not None else out_masks[j]
            if lm is not None:
                lm = lm.reshape(per_ex.shape).to(per_ex.dtype)
                total = total + (per_ex * lm).sum() / lm.sum().clamp_min(1.0)
            else:
                total = total + per_ex.mean()
        return total

    def _get_step(self):
        if self._step is None:
            from deeplearning4j_torch.optimize.fused_fit import (
                build_step_core)

            self._step = build_step_core(self)
        return self._step

    def do_step(self, xs, ys, input_masks=None, label_masks=None):
        """One training iteration; returns ``(loss, new_carry)`` with the
        loss a device tensor (no host sync) and no carry (``{}``)."""
        xs, ys, ims, lms = self._batch(xs, ys, input_masks, label_masks)
        (self.params, self.updater_state, self.state,
         loss) = self._get_step()(self.params, self.updater_state,
                                  self.state, self.iteration, xs, ys, ims,
                                  lms)
        self.iteration += 1
        self.score_value = loss
        return self.score_value, {}

    def fit(self, data, labels=None, epochs: int = 1, *,
            fused_steps: Optional[int] = None, health_guard=None):
        """Train on a DataSet or an iterable of DataSets, one ``do_step``
        per batch (JAX ``fit(..., fused_steps=1, health_guard=None)``). An
        iterable counts ``epoch`` up once per pass. The fused K-step driver
        and the health guard are not ported (ROADMAP §A5): any other
        ``fused_steps`` or a health policy raises."""
        from deeplearning4j_torch.datasets.dataset import DataSet

        if fused_steps not in (None, 1):
            raise NotImplementedError(
                f"fused_steps={fused_steps}: the fused K-step driver is not "
                "ported yet (ROADMAP §A5); use fused_steps=None or 1")
        if health_guard not in (None, False):
            raise NotImplementedError(
                "health_guard: the numerical-health guard is not ported yet "
                "(ROADMAP §A5); pass None or False")
        if self.conf.backprop_type != "standard" or self.conf.pretrain:
            raise NotImplementedError(
                f"backprop_type={self.conf.backprop_type!r}, pretrain="
                f"{self.conf.pretrain}: TBPTT and layer-wise pretraining are "
                "not ported yet (ROADMAP §A6)")
        if labels is not None:
            data = DataSet(data, labels)
        if isinstance(data, DataSet):
            for _ in range(epochs):
                self._fit_batch(data)
            return self
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            for ds in data:
                self._fit_batch(ds)
            self.epoch += 1
        return self

    def _fit_batch(self, ds):
        self.do_step(ds.features, ds.labels, ds.features_mask,
                     ds.labels_mask)

    def score(self, ds=None, x=None, y=None) -> float:
        """The last step's loss as a host float, or the loss of ``ds`` (or
        ``x``, ``y``) at the current parameters."""
        if ds is None and x is None:
            return float(self.score_value)
        if ds is not None:
            x, y = ds.features, ds.labels
            im, lm = ds.features_mask, ds.labels_mask
        else:
            im = lm = None
        xs, ys, ims, lms = self._batch(x, y, im, lm)
        with torch.no_grad():
            return float(self._loss(self.params, self.state, xs, ys, ims,
                                    lms))

    # ------------------------------------------------------- params plumbing
    def params_flat(self) -> np.ndarray:
        """Contiguous parameter vector in (topo order, param_order) order,
        as the JAX ``params_flat`` lays it out (``utils/pytree.py``)."""
        return flatten_params(self.params, self.conf)

    def set_params_flat(self, flat) -> None:
        self.params = unflatten_params(flat, self.params, self.conf)

    def num_params(self) -> int:
        return int(sum(t.numel() for lp in self.params.values()
                       for t in lp.values()))

    def _stream_layers(self):
        """(name, layer) pairs of the layers that carry serving state (KV
        pages or a position counter), keyed as the serving carry is."""
        for name, v in self.conf.vertices.items():
            layer = getattr(v, "layer", None)
            if layer is not None and layer.STREAMS:
                yield name, layer

    # -------------------------------------------------------- rnn streaming
    def rnn_clear_previous_state(self):
        self._rnn_state = None
        self._stream_pos = 0
        self._stream_capacity = None

    def _seed_streaming_carry(self, batch: int) -> dict:
        """Initial streaming carry (attention KV caches, position counters),
        keyed as ``_stream_layers``; resets the overflow accounting."""
        dtype = getattr(torch, self.conf.dtype)
        seed = {}
        caps = []
        for name, layer in self._stream_layers():
            c = layer.init_streaming_carry(batch, dtype, device=self.device)
            if c:
                seed[name] = c
                if hasattr(layer, "max_cache"):
                    caps.append(layer.max_cache)
        self._stream_pos = 0
        self._stream_capacity = min(caps) if caps else None
        return seed

    @torch.inference_mode()
    def rnn_time_step(self, *inputs):
        """Streaming inference with persistent state (JAX
        ``ComputationGraph.rnn_time_step``): each call consumes the next
        chunk of time steps (a 2-D input is one step) and returns the
        output for it; ``rnn_clear_previous_state`` starts a new stream."""
        dtype = getattr(torch, self.conf.dtype)
        xs = []
        squeeze = False
        for x in inputs:
            x = self._as_tensor(x, dtype)
            if x.dim() == 2:
                x = x[:, None, :]
                squeeze = True
            xs.append(x)
        if self._rnn_state is None:
            self._rnn_state = self._seed_streaming_carry(xs[0].shape[0])
        T_in = xs[0].shape[1]
        if self._stream_capacity is not None and \
                self._stream_pos + T_in > self._stream_capacity:
            raise ValueError(
                f"KV cache overflow: stream position {self._stream_pos} + "
                f"{T_in} new tokens > max_cache {self._stream_capacity}; "
                "raise SelfAttentionLayer.max_cache or "
                "rnn_clear_previous_state()")
        self._stream_pos += T_in
        outs, new_carry, _, _ = self._forward(
            self.params, self.state, xs, [None] * len(xs),
            carry=self._rnn_state)
        self._rnn_state = new_carry
        outs = [o[:, 0] if squeeze and o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs
