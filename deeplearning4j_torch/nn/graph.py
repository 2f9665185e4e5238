"""ComputationGraph (port of ``deeplearning4j_tpu/nn/graph.py``): parameters,
the topological forward with an optional serving carry, ``output()``,
``feed_forward``, streaming inference (``rnn_time_step`` over the attention
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

Not ported: TBPTT and layer-wise pretraining (ROADMAP A11); ``fit`` raises
on them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration, LayerVertex)
from deeplearning4j_torch.nn.regularization import penalty_value
from deeplearning4j_torch.ops import random
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


def _has_loss_head(v) -> bool:
    return isinstance(v, LayerVertex) and hasattr(v.layer,
                                                  "compute_loss_per_example")


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.params: dict = {}
        self.state: dict = {}
        self.updater_state: dict = {}
        self.iteration = 0
        self.epoch = 0
        self.listeners: list = []
        # the last step's loss: a device tensor after an unwatched step
        # (reading it is the sync), a host value where listeners or the
        # health guard fetched it
        self.score_value = float("nan")
        self.device: Optional[torch.device] = None
        # the active health policy (optimize/health.py), set by fit()
        self._health = None
        self._base_key = None             # cached PRNGKey(seed), _rng_base
        self._base_key_seed = None
        self._step_cache: dict = {}
        self._rnn_state: Optional[dict] = None
        self._stream_pos = 0              # tokens consumed this stream
        self._stream_capacity = None      # min attention max_cache, if any

    def init(self, params: Optional[dict] = None, *,
             device=None) -> "ComputationGraph":
        """Draw the weights (each layer's ``weight_init`` from a CPU
        ``torch.Generator`` seeded with ``conf.seed``, so the draw is the
        same on every device) or take ``params``, and home them on
        ``device`` (CUDA unless the caller passes another device). The
        updater state starts from ``conf.updater.init``."""
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
        self._step_cache.clear()
        return self

    def _forward(self, params, state, inputs, masks, *, train=False,
                 rng=None, carry=None, collect_loss_inputs=False):
        """Traverse the DAG in topo order. Returns (outputs list, new_carry,
        output masks list, loss_inputs), where ``loss_inputs[name]`` is the
        input of each output vertex with a loss head (what its loss
        consumes), filled when ``collect_loss_inputs``; such a vertex's own
        forward is then not run (the loss recomputes its pre-activations),
        unless another vertex reads its output. With ``rng`` (a ``[2]``
        key) vertex i of the topo order gets key i of ``split(rng, n)``,
        as the JAX forward hands them out."""
        conf = self.conf
        acts = dict(zip(conf.network_inputs, inputs))
        act_masks = dict(zip(conf.network_inputs,
                             masks or [None] * len(inputs)))
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
            if (collect_loss_inputs and name in conf.network_outputs
                    and _has_loss_head(v)):
                loss_inputs[name] = v_in[0]
                if name not in read:
                    acts[name] = None
                    continue
            vertex_state = dict(state.get(name, {}))
            if carry is not None and name in carry:
                vertex_state.update(carry[name])
            out, ns = v.forward(params.get(name, {}), vertex_state, v_in,
                                masks=v_masks, train=train,
                                rng=None if keys is None else keys[i])
            c = {k: t for k, t in ns.items() if k in _CARRY_KEYS}
            if c:
                new_carry[name] = c
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
        with torch.no_grad():
            for name in conf.topo_order:
                v = conf.vertices[name]
                out, _ = v.forward(self.params.get(name, {}),
                                   self.state.get(name, {}),
                                   [acts[k] for k in conf.vertex_inputs[name]],
                                   masks=None, train=train)
                acts[name] = out
        return acts

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
        """Output-vertex activations, in the parameter dtype whatever
        ``compute_dtype`` says; a single output returns the bare tensor.
        Inputs may be numpy arrays or tensors; they are moved to the net's
        device."""
        dtype = getattr(torch, self.conf.dtype)
        xs = [self._as_tensor(a, dtype) for a in inputs]
        ms = ([None if m is None else self._as_tensor(m, torch.float32)
               for m in _as_list(masks)] if masks is not None
              else [None] * len(xs))
        outs, _, _, _ = self._forward(self.params, self.state, xs, ms)
        return outs[0] if len(outs) == 1 else outs

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
        ``(loss, (new_state, new_carry))``."""
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
        _, new_carry, out_masks, loss_inputs = self._forward(
            fwd_params, state, xs, ims, train=train, rng=rng, carry=carry,
            collect_loss_inputs=True)
        if cd is not None:
            pdt = getattr(torch, conf.dtype)
            loss_inputs = {k: v.to(pdt) for k, v in loss_inputs.items()}
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
        return total + penalty_value(self, params), (state, new_carry)

    def _lr_mult_tree(self):
        """Per-leaf learning-rate multipliers from the layers'
        ``learning_rate``/``bias_learning_rate`` over the updater's base
        rate, or None when no layer overrides it (JAX ``_lr_mult_tree``)."""
        base_lr = getattr(self.conf.updater, "learning_rate", None)
        if not base_lr:
            return None
        any_override = False
        tree: dict = {}
        for name in self.conf.topo_order:
            v = self.conf.vertices[name]
            layer = v.layer if isinstance(v, LayerVertex) else None
            layer_lr = getattr(layer, "learning_rate", None)
            bias_lr = getattr(layer, "bias_learning_rate", None)
            biases = (layer.bias_param_names()
                      if hasattr(layer, "bias_param_names") else frozenset())
            leaf = {}
            for pname in self.params.get(name, {}):
                lr = (bias_lr if (pname in biases and bias_lr is not None)
                      else layer_lr)
                leaf[pname] = (lr / base_lr) if lr is not None else 1.0
                if lr is not None:
                    any_override = True
            tree[name] = leaf
        return tree if any_override else None

    def _rng_base(self):
        """``PRNGKey(conf.seed)`` on the net's device, cached."""
        if self._base_key is None or self._base_key_seed != self.conf.seed \
                or self._base_key.device != self.device:
            self._base_key = random.PRNGKey(self.conf.seed,
                                            device=self.device)
            self._base_key_seed = self.conf.seed
        return self._base_key

    def _step_rng(self, iteration: int):
        """The step's key, ``fold_in(PRNGKey(seed), iteration)`` as JAX
        folds it, or None when no vertex draws from it (no dropout): the
        key changes nothing then, and the threefry launches are saved."""
        if not any((getattr(getattr(v, "layer", None), "dropout", 0) or 0)
                   > 0 for v in self.conf.vertices.values()):
            return None
        return random.fold_in(self._rng_base(), iteration)

    def _get_step(self, key):
        """The cached step function for ``key``: ``("step", guarded)`` the
        per-minibatch core, ``("fused", K, guarded)`` the K-step block."""
        if key not in self._step_cache:
            from deeplearning4j_torch.optimize.fused_fit import (
                build_fused_step, build_step_core)

            if key[0] == "fused":
                self._step_cache[key] = build_fused_step(self,
                                                         guarded=key[-1])
            else:
                self._step_cache[key] = build_step_core(self,
                                                        guarded=key[-1])
        return self._step_cache[key]

    def do_step(self, xs, ys, input_masks=None, label_masks=None,
                carry=None):
        """One training iteration; returns ``(loss, new_carry)``, the loss a
        device tensor (no host sync unless the health guard is on, which
        fetches the loss and the skip flag to observe them)."""
        xs, ys, ims, lms = self._batch(xs, ys, input_masks, label_masks)
        health = self._health
        guarded = health is not None
        step = self._get_step(("step", guarded))
        out = step(self.params, self.updater_state, self.state,
                   self._step_rng(self.iteration), self.iteration, xs, ys,
                   ims, lms, carry)
        if guarded:
            (self.params, self.updater_state, self.state, new_carry, loss,
             skip) = out
        else:
            self.params, self.updater_state, self.state, new_carry, loss = out
        self.iteration += 1
        self.score_value = loss
        it_done = self.iteration
        if guarded:
            # observe before the listeners: gated checkpointers read this
            # step's skip state
            score_h, skip_h = torch.stack(
                [loss.float(), skip]).cpu().numpy()
            health.observe(self, score_h, skip_h, it_done - 1)
        for listener in self.listeners:
            listener.iteration_done(self, it_done)
        return self.score_value, new_carry

    def fit(self, data, labels=None, epochs: int = 1, *,
            fused_steps: Optional[int] = None, prefetch_depth: int = 2,
            health_guard=True):
        """Train on a DataSet, a MultiDataSet or an iterable of either (JAX
        ``fit``, with its defaults).

        DataSet streams take the fused K-step driver
        (``optimize/fused_fit.py``; ``fused_steps=None`` is 4 on CUDA and 2
        on the CPU, ``fused_steps=1`` opts out); MultiDataSet batches take
        the per-minibatch path. ``health_guard`` (default on): the device
        skip of non-finite steps and the host recovery ladder
        (``optimize/health.py``); ``None``/``False`` turn it off, a
        ``HealthPolicy`` configures it. An iterable counts ``epoch`` up
        once per pass and fires the listeners' ``on_epoch_start`` and
        ``on_epoch_end``. TBPTT and layer-wise pretraining raise (ROADMAP
        A11)."""
        from deeplearning4j_torch.datasets.dataset import (DataSet,
                                                           MultiDataSet)
        from deeplearning4j_torch.optimize.fused_fit import (
            FusedFitDriver, resolve_fused_steps)
        from deeplearning4j_torch.optimize.health import (
            resolve_health_policy)

        if self.conf.backprop_type != "standard" or self.conf.pretrain:
            raise NotImplementedError(
                f"backprop_type={self.conf.backprop_type!r}, pretrain="
                f"{self.conf.pretrain}: TBPTT and layer-wise pretraining are "
                "not ported yet (ROADMAP A11)")
        if labels is not None:
            data = DataSet(data, labels)
        K = resolve_fused_steps(self, fused_steps)
        policy = resolve_health_policy(health_guard)
        prev_health = self._health
        if policy is not None:
            policy.bind(self)
        self._health = policy
        try:
            if isinstance(data, (DataSet, MultiDataSet)):
                if K > 1 and epochs > 1 and isinstance(data, DataSet):
                    # repeated single-batch fit: the epochs loop is fused
                    # (this path fires no epoch listeners)
                    FusedFitDriver(self, K, prefetch_depth).fit_stream(
                        data for _ in range(epochs))
                    return self
                for _ in range(epochs):
                    self._fit_batch(data)
                return self
            driver = (FusedFitDriver(self, K, prefetch_depth)
                      if K > 1 else None)
            for _ in range(epochs):
                for listener in self.listeners:
                    listener.on_epoch_start(self)
                if hasattr(data, "reset"):
                    data.reset()
                if driver is not None:
                    driver.fit_stream(iter(data))
                else:
                    for ds in data:
                        self._fit_batch(ds)
                for listener in self.listeners:
                    listener.on_epoch_end(self)
                self.epoch += 1
            return self
        finally:
            self._health = prev_health

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
        self.do_step(ds.features, ds.labels, ds.features_mask,
                     ds.labels_mask)

    def score(self, ds=None, x=None, y=None) -> float:
        """The last step's loss as a host float, or the loss of ``ds`` (a
        DataSet or MultiDataSet; or ``x``, ``y``) at the current
        parameters."""
        from deeplearning4j_torch.datasets.dataset import MultiDataSet

        if ds is None and x is None:
            return float(self.score_value)
        if isinstance(ds, MultiDataSet):
            x, y = ds.features, ds.labels
            im, lm = ds.features_masks, ds.labels_masks
        elif ds is not None:
            x, y = ds.features, ds.labels
            im, lm = ds.features_mask, ds.labels_mask
        else:
            im = lm = None
        xs, ys, ims, lms = self._batch(x, y, im, lm)
        with torch.no_grad():
            return float(self._loss(self.params, self.state, xs, ys, ims,
                                    lms)[0])

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

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
        output for it, in the parameter dtype; ``rnn_clear_previous_state`` starts a new stream."""
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
            self.params, self.state, xs, [None] * len(xs), train=False,
            rng=None, carry=self._rnn_state)
        self._rnn_state = new_carry
        outs = [o[:, 0] if squeeze and o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs
