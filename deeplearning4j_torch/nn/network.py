"""What ``MultiLayerNetwork`` and ``ComputationGraph`` share: the training
plumbing the JAX package writes twice (``nn/multilayer.py`` and
``nn/graph.py``) with the same semantics.

A net names its parameter owners with ``_param_owners()``: ``{key: layer
or vertex}`` in the flat-vector order (a MultiLayerNetwork's layer indices
``"0"``, ``"1"``, ...; a graph's vertex names in topological order), each
key also a key of ``params``, ``state`` and the gradient trees. On that
map rest ``init`` (the weights of each owner drawn from one CPU generator
seeded with ``conf.seed``, so the draw is the same on every device), the
flat parameter vector, the per-layer learning rates, the L1/L2 penalty and
gradient normalization. A subclass adds its forward, ``_loss``,
``_batch`` (inputs in the net's own form), ``_fit_batch`` and
``output``.

Training: ``do_step`` runs the cached step core (``optimize/fused_fit.py``)
keyed by ``fold_in(PRNGKey(seed), iteration)`` where anything draws;
``fit`` has the JAX package's signature and defaults (the fused K-step
driver, the health guard on). Under ``backprop_type="tbptt"`` a
sequence batch trains by truncated BPTT (``_fit_tbptt``: one step per
``tbptt_fwd_length`` segment, the recurrent state carried between them).
``conf.pretrain`` is stored and not read by ``fit``, as in the JAX
package: layer-wise pretraining is ``MultiLayerNetwork.pretrain``.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.utils.pytree import (flatten_params,
                                               unflatten_params)

#: state keys that belong to the streaming, serving or TBPTT carry rather
#: than the layer state: a recurrent layer's h/c, dense KV caches
#: (``rnn_time_step``) and paged pools
CARRY_KEYS = ("h", "c", "cache_pos", "kcache", "vcache", "kscale", "vscale",
              "kpages", "vpages", "block_table", "kscales", "vscales")


def layer_forward(layer, params, state, x, **kw):
    """``layer.forward``, or the partitioned forward a sharded program
    attached to the layer's params (``parallel/model_sharding.py``)."""
    tp = getattr(params, "tp_forward", None)
    if tp is not None:
        return tp(layer, state, x, **kw)
    return layer.forward(params, state, x, **kw)


class Network:
    def __init__(self, conf):
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

    def _param_owners(self) -> dict:
        """``{key: layer or vertex}`` in the flat-vector order."""
        raise NotImplementedError

    def _preprocessors(self) -> list:
        """The net's input preprocessors."""
        raise NotImplementedError

    def init(self, params: Optional[dict] = None, *, device=None):
        """Draw the weights (each owner's ``weight_init`` from a CPU
        ``torch.Generator`` seeded with ``conf.seed``) or take ``params``,
        home them on ``device`` (CUDA unless the caller passes another
        device), start each layer's state and the updater state."""
        self.device = resolve_device(device)
        dtype = getattr(torch, self.conf.dtype)
        owners = self._param_owners()
        if params is None:
            gen = torch.Generator(device="cpu").manual_seed(self.conf.seed)
            params = {k: o.init_params(gen, dtype, "cpu")
                      for k, o in owners.items()}
        self.params = {k: {n: torch.as_tensor(t).to(self.device)
                           for n, t in p.items()}
                       for k, p in params.items()}
        self.state = {k: o.init_state(dtype, self.device)
                      for k, o in owners.items()}
        self.updater_state = self.conf.updater.init(self.params)
        self._step_cache.clear()
        return self

    def _as_tensor(self, a, dtype=None):
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        return t.to(device=self.device, dtype=dtype or t.dtype)

    # ------------------------------------------------------------- training
    def _lr_mult_tree(self):
        """Per-leaf learning-rate multipliers from the layers'
        ``learning_rate``/``bias_learning_rate`` over the updater's base
        rate, or None when no layer overrides it (JAX ``_lr_mult_tree``)."""
        base_lr = getattr(self.conf.updater, "learning_rate", None)
        if not base_lr:
            return None
        any_override = False
        tree: dict = {}
        for key, layer in self._param_owners().items():
            layer_lr = getattr(layer, "learning_rate", None)
            bias_lr = getattr(layer, "bias_learning_rate", None)
            biases = (layer.bias_param_names()
                      if hasattr(layer, "bias_param_names") else frozenset())
            leaf = {}
            for pname in self.params.get(key, {}):
                lr = (bias_lr if (pname in biases and bias_lr is not None)
                      else layer_lr)
                leaf[pname] = (lr / base_lr) if lr is not None else 1.0
                if lr is not None:
                    any_override = True
            tree[key] = leaf
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
        folds it, or None when nothing draws from it (no dropout, no
        stochastic preprocessor): the key changes nothing then, and the
        threefry launches are saved."""
        draws = any((getattr(o, "dropout", 0) or 0) > 0
                    for o in self._param_owners().values()) \
            or any(p.DRAWS for p in self._preprocessors())
        if not draws:
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

    def do_step(self, x, y, input_mask=None, label_mask=None, carry=None):
        """One training iteration; returns ``(loss, new_carry)``, the loss a
        device tensor (no host sync unless the health guard is on, which
        fetches the loss and the skip flag to observe them). A
        process-local ``ShardedArray`` (``parallel/mesh.py::
        make_array_from_process_local_data``) first shards an unsharded net
        over its mesh, as JAX's step returns params placed on the inputs'
        global mesh (``parallel/model_sharding.py``)."""
        if getattr(self, "_sharded", None) is None and getattr(
                x, "process_local", False):
            from deeplearning4j_torch.parallel.model_sharding import (
                shard_network)

            shard_network(self, x.sharding.mesh)
        x, y, im, lm = self._batch(x, y, input_mask, label_mask)
        health = self._health
        guarded = health is not None
        step = self._get_step(("step", guarded))
        out = step(self.params, self.updater_state, self.state,
                   self._step_rng(self.iteration), self.iteration, x, y,
                   im, lm, carry)
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
        on the CPU, ``fused_steps=1`` opts out); other batches take the
        per-minibatch path. ``health_guard`` (default on): the device skip
        of non-finite steps and the host recovery ladder
        (``optimize/health.py``); ``None``/``False`` turn it off, a
        ``HealthPolicy`` configures it. An iterable counts ``epoch`` up
        once per pass and fires the listeners' ``on_epoch_start`` and
        ``on_epoch_end``. Under ``backprop_type="tbptt"`` every batch takes
        the per-minibatch path (K = 1) and a sequence batch is trained by
        ``_fit_tbptt``. ``conf.pretrain`` is not read (JAX's ``fit`` does
        not read it either)."""
        from deeplearning4j_torch.datasets.dataset import (DataSet,
                                                           MultiDataSet)
        from deeplearning4j_torch.optimize.fused_fit import (
            FusedFitDriver, resolve_fused_steps)
        from deeplearning4j_torch.optimize.health import (
            resolve_health_policy)

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

    def _fit_tbptt(self, ds):
        """Truncated BPTT over one DataSet of ``[B, T, F]`` features (JAX
        ``_fit_tbptt``, which the JAX package writes once per net): one
        ``do_step`` per ``tbptt_fwd_length`` segment of the time axis (the
        last may be shorter), the features mask and labels mask cut with
        it and the labels only when they are 3-D. The recurrent state is
        carried from segment to segment (an empty carry on the first; a
        step the health guard skips hands back the carry it was given),
        detached between them (the step core hands it back out of the
        autograd graph), and dropped at the end of the batch."""
        T = ds.features.shape[1]
        L = self.conf.tbptt_fwd_length
        carry: dict = {}
        for s in range(max(1, math.ceil(T / L))):
            sl = slice(s * L, min((s + 1) * L, T))
            fy = ds.labels[:, sl] if ds.labels.ndim == 3 else ds.labels
            fm = (ds.features_mask[:, sl] if ds.features_mask is not None
                  else None)
            lm = ds.labels_mask[:, sl] if ds.labels_mask is not None else None
            _, carry = self.do_step(ds.features[:, sl], fy, fm, lm,
                                    carry=carry)

    def score(self, ds=None, x=None, y=None) -> float:
        """The last step's loss as a host float, or the loss of ``ds`` (or
        ``x``, ``y``) at the current parameters."""
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

    def evaluate(self, data, labels=None, *, top_n: int = 1, fused=None,
                 eval_batches: Optional[int] = None, prefetch_depth: int = 2):
        """Classification evaluation of the (first) output (JAX
        ``evaluate``). By default the device-resident fused evaluator
        (``evaluation/fused_eval.py``: forward, argmax and the count
        accumulation on the device, ``eval_batches`` batches per block,
        one host fetch per call); ``fused=False`` is the per-batch path
        (``output()`` and host counting)."""
        from deeplearning4j_torch.datasets.dataset import DataSet
        from deeplearning4j_torch.evaluation.classification import Evaluation

        ev = Evaluation(top_n=top_n)
        if labels is not None:
            data = [DataSet(data, labels)]
        elif isinstance(data, DataSet):
            data = [data]
        elif hasattr(data, "reset"):
            data.reset()
        if fused is None or fused:
            from deeplearning4j_torch.evaluation.fused_eval import (
                FusedEvalDriver)
            return FusedEvalDriver(self, eval_batches,
                                   prefetch_depth).evaluate(data, ev)
        for ds in data:
            out = self._output_one(ds.features, ds.features_mask)
            ev.eval(ds.labels, out.float().cpu().numpy(), mask=ds.labels_mask)
        return ev

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    # ------------------------------------------------------- params plumbing
    def params_flat(self) -> np.ndarray:
        """One contiguous parameter vector in ``_param_owners`` order, each
        owner's parameters in its ``param_order`` (``utils/pytree.py``)."""
        return flatten_params(self.params, self._param_owners())

    def set_params_flat(self, flat) -> None:
        self.params = unflatten_params(flat, self.params,
                                       self._param_owners())

    def num_params(self) -> int:
        return int(sum(t.numel() for lp in self.params.values()
                       for t in lp.values()))

    def clone(self):
        """A copy of the net on its device: configuration, parameters,
        layer state, updater state and iteration."""
        def copied(tree):
            if isinstance(tree, dict):
                return {k: copied(v) for k, v in tree.items()}
            return tree.clone()

        net = type(self)(copy.deepcopy(self.conf))
        net.init(copied(self.params), device=self.device)
        net.state = copied(self.state)
        net.updater_state = copied(self.updater_state)
        net.iteration = self.iteration
        return net

    # -------------------------------------------------------- rnn streaming
    def _stream_layers(self):
        """(key, layer) pairs of the layers that carry serving state (KV
        pages or a position counter), keyed as the serving carry is."""
        for key, layer in self._param_owners().items():
            if getattr(layer, "STREAMS", False):
                yield key, layer

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

    def _stream_advance(self, batch: int, t_in: int) -> dict:
        """The carry for the next ``t_in`` streamed steps (seeded on a
        fresh stream), after checking them against the KV capacity."""
        if self._rnn_state is None:
            self._rnn_state = self._seed_streaming_carry(batch)
        if self._stream_capacity is not None and \
                self._stream_pos + t_in > self._stream_capacity:
            raise ValueError(
                f"KV cache overflow: stream position {self._stream_pos} + "
                f"{t_in} new tokens > max_cache {self._stream_capacity}; "
                "raise SelfAttentionLayer.max_cache or "
                "rnn_clear_previous_state()")
        self._stream_pos += t_in
        return self._rnn_state
