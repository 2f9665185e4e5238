"""ComputationGraph (port of ``deeplearning4j_tpu/nn/graph.py``): parameters,
the topological forward with an optional serving carry, ``output()``,
``feed_forward``, ``output(train=)`` (JAX's batch bucketing included),
streaming inference (``rnn_time_step`` over the attention
layers' dense KV caches), ``_stream_layers``, and training: ``_loss`` (with
``compute_dtype`` mixed precision and the reported L1/L2 penalty),
``do_step``, ``fit`` at the JAX package's defaults (the fused K-step driver
and the numerical-health guard on), listeners, ``score`` and the
flat-parameter plumbing.

Params keep the JAX pytree shape, ``{vertex_name: {param: Tensor}}``, so the
reference's weights load unchanged (``utils/convert.py``); the updater state
is a dict of such trees. One training step is ``build_step_core``
(``optimize/fused_fit.py``): autograd of ``_loss``, the closed-form
regularization gradients, the finite check (guarded), gradient
normalization, the updater with per-layer learning rates, then ``params -
steps``. ``compute_dtype`` acts only in ``_loss``: ``output()``,
``rnn_time_step`` and the servers run in the parameter dtype, as JAX's do.

The training plumbing it shares with ``MultiLayerNetwork`` is
``nn/network.py``, truncated BPTT included: a graph with one network
input sends a 3-D DataSet to it under ``backprop_type="tbptt"``. Vertices
see the network inputs and their masks through ``ctx`` (what
``LastTimeStepVertex`` and ``DuplicateToTimeSeriesVertex`` read). Not
ported: layer-wise pretraining (ROADMAP A11b); ``fit`` raises on it.
"""

from __future__ import annotations

import torch

from deeplearning4j_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration, LayerVertex)
from deeplearning4j_torch.nn.conf.layers.misc import CenterLossOutputLayer
from deeplearning4j_torch.nn.network import CARRY_KEYS, Network
from deeplearning4j_torch.nn.regularization import penalty_value
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.optimize.bucketing import bucket_rows, pad_rows

def _as_list(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _has_loss_head(v) -> bool:
    return isinstance(v, LayerVertex) and hasattr(v.layer,
                                                  "compute_loss_per_example")


class ComputationGraph(Network):
    conf: ComputationGraphConfiguration

    def _param_owners(self) -> dict:
        """Each vertex in topological order, as its layer where it has
        one."""
        return {name: getattr(self.conf.vertices[name], "layer", None)
                or self.conf.vertices[name] for name in self.conf.topo_order}

    def _preprocessors(self) -> list:
        """The layer vertices' input preprocessors and the preprocessor
        vertices'."""
        return [v.preprocessor for v in self.conf.vertices.values()
                if getattr(v, "preprocessor", None) is not None]

    def _forward(self, params, state, inputs, masks, *, train=False,
                 rng=None, carry=None, collect_loss_inputs=False,
                 new_states=None):
        """Traverse the DAG in topo order. Returns (outputs list, new_carry,
        output masks list, loss_inputs), where ``loss_inputs[name]`` is the
        post-preprocessor input of each output vertex with a loss head
        (what its loss consumes), filled when ``collect_loss_inputs``; such
        a vertex's own forward is then not run (the loss recomputes its
        pre-activations), unless another vertex reads its output. With
        ``rng`` (a ``[2]`` key) vertex i of the topo order gets key i of
        ``split(rng, n)``, as the JAX forward hands them out. A
        ``new_states`` dict receives each vertex's new layer state (batch
        norm's running statistics)."""
        conf = self.conf
        acts = dict(zip(conf.network_inputs, inputs))
        act_masks = dict(zip(conf.network_inputs,
                             masks or [None] * len(inputs)))
        ctx = {"input_arrays": dict(acts), "input_masks": dict(act_masks)}
        keys = (random.split(rng, max(len(conf.topo_order), 1))
                if rng is not None else None)
        read = {i for ins in conf.vertex_inputs.values() for i in ins}
        new_carry: dict = {}
        loss_inputs: dict = {}
        for i, name in enumerate(conf.topo_order):
            v = conf.vertices[name]
            v_in = [acts[k] for k in conf.vertex_inputs[name]]
            v_masks = [act_masks.get(k) for k in conf.vertex_inputs[name]]
            act_masks[name] = v.feed_forward_mask(v_masks)
            k = None if keys is None else keys[i]
            if (collect_loss_inputs and name in conf.network_outputs
                    and _has_loss_head(v)):
                loss_inputs[name] = v.preprocess(v_in[0], k)
                if name not in read:
                    acts[name] = None
                    continue
            vertex_state = dict(state.get(name, {}))
            if carry is not None and name in carry:
                vertex_state.update(carry[name])
            out, ns = v.forward(params.get(name, {}), vertex_state, v_in,
                                masks=v_masks, ctx=ctx, train=train, rng=k)
            c = {n: t for n, t in ns.items() if n in CARRY_KEYS}
            if c:
                new_carry[name] = c
            if new_states is not None:
                new_states[name] = {n: t for n, t in ns.items()
                                    if n not in CARRY_KEYS}
            acts[name] = out
        outs = [acts[o] for o in conf.network_outputs]
        out_masks = [act_masks.get(o) for o in conf.network_outputs]
        return outs, new_carry, out_masks, loss_inputs

    def feed_forward(self, *inputs, train: bool = False):
        """Every vertex's activation as ``{name: tensor}`` (no key, so
        ``train=True`` draws no dropout, as in JAX)."""
        conf = self.conf
        dtype = getattr(torch, conf.dtype)
        acts = {k: self._as_tensor(a, dtype)
                for k, a in zip(conf.network_inputs, inputs)}
        ctx = {"input_arrays": dict(acts), "input_masks": {}}
        with torch.no_grad():
            for name in conf.topo_order:
                v = conf.vertices[name]
                out, _ = v.forward(self.params.get(name, {}),
                                   self.state.get(name, {}),
                                   [acts[k] for k in conf.vertex_inputs[name]],
                                   masks=None, ctx=ctx, train=train)
                acts[name] = out
        return acts

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
    def output(self, *inputs, train: bool = False, masks=None):
        """Output-vertex activations, in the parameter dtype whatever
        ``compute_dtype`` says; a single output returns the bare tensor.
        Inputs may be numpy arrays or tensors; they are moved to the net's
        device. ``train=True`` runs the training forward with no key (batch
        statistics, no dropout) and drops the new batch-norm state, as
        JAX's does; its shared batch is then padded to the next power of
        two by repeating the last row and the padding cut from every
        output, as the JAX package buckets it, since batch statistics see
        the padded rows (an inference forward is row-wise and runs
        unpadded)."""
        dtype = getattr(torch, self.conf.dtype)
        xs = [self._as_tensor(a, dtype) for a in inputs]
        ms = ([None if m is None else self._as_tensor(m, torch.float32)
               for m in _as_list(masks)] if masks is not None
              else [None] * len(xs))
        n = xs[0].shape[0]
        B = bucket_rows(n) if train else n
        if B != n:
            xs = [pad_rows(a, B) for a in xs]
            ms = [None if m is None else pad_rows(m, B) for m in ms]
        outs, _, _, _ = self._forward(self.params, self.state, xs, ms,
                                      train=train)
        if B != n:
            outs = [o[:n] for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def _output_one(self, x, mask):
        return self.output(x, masks=mask)

    # ------------------------------------------------------------- training
    def _loss(self, params, state, x, y, input_mask, label_mask, *,
              train=False, rng=None, carry=None):
        """The training loss (JAX ``_loss``): each output vertex's per-example
        loss, averaged over its label mask (else the propagated output mask,
        else a plain mean), summed over the outputs, plus the L1/L2 penalty
        value (reported, not differentiated: the step adds its closed-form
        gradient). Under ``compute_dtype`` every vertex but the outputs and
        the inputs compute in that dtype (the casts inside the autograd
        graph, so the gradients come back in the parameter dtype) and the
        loss heads take their inputs back in the parameter dtype. Returns
        ``(loss, (new_state, new_carry, loss_inputs))``; a
        ``CenterLossOutputLayer`` head adds its center term from its
        state, and the step moves its centers from ``loss_inputs``."""
        conf = self.conf
        xs, ys = _as_list(x), _as_list(y)
        ims = _as_list(input_mask) or [None] * len(xs)
        lms = _as_list(label_mask) or [None] * len(ys)
        cd = conf.compute_dtype
        fwd_params = params
        if cd is not None:
            cdt = getattr(torch, cd)
            outs_set = set(conf.network_outputs)
            fwd_params = {k: (v if k in outs_set
                              else {n: t.to(cdt) for n, t in v.items()})
                          for k, v in params.items()}
            xs = [a.to(cdt) for a in xs]
        new_states: dict = {}
        _, new_carry, out_masks, loss_inputs = self._forward(
            fwd_params, state, xs, ims, train=train, rng=rng, carry=carry,
            collect_loss_inputs=True, new_states=new_states)
        if cd is not None:
            pdt = getattr(torch, conf.dtype)
            loss_inputs = {k: v.to(pdt) for k, v in loss_inputs.items()}
        total = 0.0
        for j, name in enumerate(conf.network_outputs):
            if name not in loss_inputs:
                raise ValueError(f"Output vertex '{name}' has no loss head")
            layer = conf.vertices[name].layer
            if isinstance(layer, CenterLossOutputLayer):
                per_ex = layer.compute_loss_per_example(
                    params[name], loss_inputs[name], ys[j],
                    state=state.get(name))
            else:
                per_ex = layer.compute_loss_per_example(
                    params[name], loss_inputs[name], ys[j])
            new_states.setdefault(name, state.get(name, {}))
            lm = lms[j] if lms[j] is not None else out_masks[j]
            if lm is not None:
                lm = lm.reshape(per_ex.shape).to(per_ex.dtype)
                total = total + (per_ex * lm).sum() / lm.sum().clamp_min(1.0)
            else:
                total = total + per_ex.mean()
        return total + penalty_value(self, params), (new_states, new_carry,
                                                     loss_inputs)

    def _fit_batch(self, ds):
        from deeplearning4j_torch.datasets.dataset import MultiDataSet

        if isinstance(ds, MultiDataSet):
            self.do_step(ds.features, ds.labels,
                         ds.features_masks if any(
                             m is not None for m in ds.features_masks)
                         else None,
                         ds.labels_masks if any(
                             m is not None for m in ds.labels_masks)
                         else None)
            return
        if (self.conf.backprop_type == "tbptt" and ds.features.ndim == 3
                and len(self.conf.network_inputs) == 1):
            self._fit_tbptt(ds)
        else:
            self.do_step(ds.features, ds.labels, ds.features_mask,
                         ds.labels_mask)

    # -------------------------------------------------------- rnn streaming
    @torch.inference_mode()
    def rnn_time_step(self, *inputs):
        """Streaming inference with persistent state (JAX
        ``ComputationGraph.rnn_time_step``): each call consumes the next
        chunk of time steps (a 2-D input is one step), carrying the
        recurrent layers' h/c and the attention layers' KV caches, and
        returns the output for it, in the parameter dtype;
        ``rnn_clear_previous_state`` starts a new stream."""
        dtype = getattr(torch, self.conf.dtype)
        xs = []
        squeeze = False
        for x in inputs:
            x = self._as_tensor(x, dtype)
            if x.dim() == 2:
                x = x[:, None, :]
                squeeze = True
            xs.append(x)
        carry = self._stream_advance(xs[0].shape[0], xs[0].shape[1])
        outs, new_carry, _, _ = self._forward(
            self.params, self.state, xs, [None] * len(xs), train=False,
            rng=None, carry=carry)
        self._rnn_state = new_carry
        outs = [o[:, 0] if squeeze and o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs
