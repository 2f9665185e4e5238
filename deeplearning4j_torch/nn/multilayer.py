"""MultiLayerNetwork (port of ``deeplearning4j_tpu/nn/multilayer.py``): the
sequential net. Params keep the JAX pytree shape, ``{layer index:
{param: Tensor}}`` with string indices ``"0"``, ``"1"``, ..., so the
reference's weights and zips load unchanged (``utils/convert.py``,
``utils/model_serializer.py``); the layer state (batch norm's running
statistics, the center-loss centers) is a tree of the same shape.

The forward hands layer i key i of ``split(rng, n)`` and a preprocessor in
front of it ``preprocessor_key`` of that key, as the JAX forward does, so
dropout masks and Bernoulli samples are JAX's bit for bit. ``_loss``
runs layers ``[0, n-1)``, the output layer's preprocessor, and the output
head's per-example loss from its pre-activations (``compute_dtype``
casts the body only), plus the reported L1/L2 penalty. Training,
evaluation and the flat parameters are ``nn/network.py``'s; ``output``
pads the batch to a power of two (``optimize/bucketing.py``) as JAX's
does. ``_fit_batch`` sends a 3-D DataSet to truncated BPTT under
``backprop_type="tbptt"``; ``rnn_time_step`` streams the recurrent layers'
h/c and the attention layers' KV caches. ``pretrain`` trains the RBM,
AutoEncoder and VAE layers one at a time on their unsupervised losses,
as JAX's does.
"""

from __future__ import annotations

import torch

from deeplearning4j_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_torch.nn.conf.layers.misc import CenterLossOutputLayer
from deeplearning4j_torch.nn.conf.preprocessors import preprocessor_key
from deeplearning4j_torch.nn.network import CARRY_KEYS, Network
from deeplearning4j_torch.nn.regularization import (add_regularization_grads,
                                                   penalty_value)
from deeplearning4j_torch.optimize.bucketing import bucket_rows, pad_rows
from deeplearning4j_torch.ops import random


class MultiLayerNetwork(Network):
    conf: MultiLayerConfiguration

    def __init__(self, conf: MultiLayerConfiguration):
        super().__init__(conf)
        self.layers = conf.layers

    def _param_owners(self) -> dict:
        return {str(i): layer for i, layer in enumerate(self.layers)}

    def _preprocessors(self) -> list:
        return list(self.conf.preprocessors.values())

    # ------------------------------------------------------------- forward
    def _forward(self, params, state, x, mask, *, train=False, rng=None,
                 carry=None, upto=None, new_states=None):
        """Run layers ``[0, upto)``; returns ``(x, new_carry, mask)``. A
        ``new_states`` dict receives each layer's new state."""
        n = len(self.layers) if upto is None else upto
        keys = random.split(rng, max(n, 1)) if rng is not None else None
        new_carry = {}
        for i in range(n):
            layer = self.layers[i]
            k = None if keys is None else keys[i]
            prep = self.conf.preprocessors.get(i)
            if prep is not None:
                # a derived key, never keys[i]: the preprocessor must not
                # share its uniforms with the layer behind it
                x = prep.forward(x, rng=preprocessor_key(k))
                mask = prep.feed_forward_mask(mask)
            key = str(i)
            layer_state = dict(state.get(key, {}))
            if carry is not None and key in carry:
                layer_state.update(carry[key])
            x, ns = layer.forward(params[key], layer_state, x, mask=mask,
                                  train=train, rng=k)
            c = {n_: t for n_, t in ns.items() if n_ in CARRY_KEYS}
            if c:
                new_carry[key] = c
            if new_states is not None:
                new_states[key] = {n_: t for n_, t in ns.items()
                                   if n_ not in CARRY_KEYS}
            mask = layer.feed_forward_mask(mask)
        return x, new_carry, mask

    def feed_forward(self, x, train: bool = False):
        """Every layer's activation, the input first (no key, so
        ``train=True`` draws nothing)."""
        cur = self._as_tensor(x, getattr(torch, self.conf.dtype))
        acts = [cur]
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                if i in self.conf.preprocessors:
                    cur = self.conf.preprocessors[i].forward(cur)
                cur, _ = layer.forward(self.params[str(i)],
                                       self.state.get(str(i), {}), cur,
                                       train=train)
                acts.append(cur)
        return acts

    def _batch(self, x, y, input_mask, label_mask):
        """Features and labels in the param dtype and masks in f32, as
        tensors on the net's device."""
        dtype = getattr(torch, self.conf.dtype)

        def mask(m):
            return None if m is None else self._as_tensor(m, torch.float32)

        return (self._as_tensor(x, dtype), self._as_tensor(y, dtype),
                mask(input_mask), mask(label_mask))

    @torch.inference_mode()
    def output(self, x, train: bool = False, mask=None):
        """The output layer's activations in the parameter dtype. The batch
        is padded to the next power of two by repeating its last row and
        the padding cut from the result, as the JAX package buckets it."""
        x = self._as_tensor(x, getattr(torch, self.conf.dtype))
        mask = None if mask is None else self._as_tensor(mask,
                                                         torch.float32)
        n = x.shape[0]
        B = bucket_rows(n)
        if B != n:
            x = pad_rows(x, B)
            if mask is not None:
                mask = pad_rows(mask, B)
        out, _, _ = self._forward(self.params, self.state, x, mask,
                                  train=train)
        return out if B == n else out[:n]

    def _output_one(self, x, mask):
        return self.output(x, mask=mask)

    # --------------------------------------------------------------- loss
    def _loss(self, params, state, x, y, input_mask, label_mask, *,
              train=False, rng=None, carry=None):
        """The training loss (JAX ``_loss``): the output head's per-example
        loss of its input, averaged over the label mask (else the
        propagated mask, else a plain mean), plus the L1/L2 penalty value
        (reported, not differentiated: the step adds its closed-form
        gradient). Under ``compute_dtype`` the body layers compute in that
        dtype and the head in the parameter dtype. Returns ``(loss,
        (new_states, new_carry, last_in))``, ``last_in`` the head's
        input (what a center-loss head's center update reads)."""
        out_idx = len(self.layers) - 1
        cd = self.conf.compute_dtype
        fwd_params = params
        if cd is not None:
            cdt = getattr(torch, cd)
            fwd_params = {k: (v if k == str(out_idx)
                              else {n: t.to(cdt) for n, t in v.items()})
                          for k, v in params.items()}
            x = x.to(cdt)
        new_states: dict = {}
        last_in, new_carry, cur_mask = self._forward(
            fwd_params, state, x, input_mask, train=train, rng=rng,
            carry=carry, upto=out_idx, new_states=new_states)
        if cd is not None:
            last_in = last_in.to(getattr(torch, self.conf.dtype))
        out_layer = self.layers[out_idx]
        prep = self.conf.preprocessors.get(out_idx)
        if prep is not None:
            # the forward split rng already; only a derived key is drawn
            last_in = prep.forward(last_in, rng=preprocessor_key(rng))
        p_out = params[str(out_idx)]
        if isinstance(out_layer, CenterLossOutputLayer):
            per_ex = out_layer.compute_loss_per_example(
                p_out, last_in, y, state=state.get(str(out_idx)))
        else:
            per_ex = out_layer.compute_loss_per_example(p_out, last_in, y)
        lm = label_mask if label_mask is not None else cur_mask
        if lm is not None:
            lm = lm.reshape(per_ex.shape).to(per_ex.dtype)
            data_loss = (per_ex * lm).sum() / lm.sum().clamp_min(1.0)
        else:
            data_loss = per_ex.mean()
        new_states[str(out_idx)] = state.get(str(out_idx), {})
        return (data_loss + penalty_value(self, params),
                (new_states, new_carry, last_in))

    def _fit_batch(self, ds):
        if self.conf.backprop_type == "tbptt" and ds.features.ndim == 3:
            self._fit_tbptt(ds)
        else:
            self.do_step(ds.features, ds.labels, ds.features_mask,
                         ds.labels_mask)

    # ---------------------------------------------------------- pretraining
    def pretrain(self, data_iterator, epochs: int = 1):
        """Layer-wise unsupervised pretraining (JAX ``pretrain``): each
        layer with a ``pretrain_loss_per_example`` (RBM, VAE) or a
        ``reconstruction_loss_per_example`` (AutoEncoder), in order, for
        ``epochs`` passes over ``data_iterator`` (a DataSet or an iterable
        of them; ``reset()`` each epoch). Labels are not read. Like JAX's,
        it leaves ``iteration`` where it was and fires no listener."""
        for i, layer in enumerate(self.layers):
            if not hasattr(layer, "pretrain_loss_per_example") and \
                    not hasattr(layer, "reconstruction_loss_per_example"):
                continue
            self._pretrain_layer(i, data_iterator, epochs)
        return self

    def _pretrain_layer(self, idx, data_iterator, epochs):
        """Train layer ``idx`` alone with fresh ``conf.updater`` state. Step
        ``it`` (counted from 0 over the epochs) keys
        ``fold_in(PRNGKey(seed + idx), it)``, split three ways as JAX
        splits it: the inference forward of layers ``[0, idx)``, the
        layer's input preprocessor, and the loss. The gradient of the mean
        loss gains the closed-form L1/L2 gradients (biases take
        ``l1_bias``/``l2_bias``) before the updater steps at ``it``.
        Returns the per-step losses (0-d device tensors, not fetched)."""
        layer = self.layers[idx]
        key = str(idx)
        loss_fn = (getattr(layer, "pretrain_loss_per_example", None)
                   or layer.reconstruction_loss_per_example)
        updater = self.conf.updater
        opt_state = updater.init({key: self.params[key]})
        base = random.PRNGKey(self.conf.seed + idx, device=self.device)
        dtype = getattr(torch, self.conf.dtype)
        batches = ([data_iterator] if hasattr(data_iterator, "features")
                   else data_iterator)
        losses = []
        it = 0
        for _ in range(epochs):
            if hasattr(data_iterator, "reset"):
                data_iterator.reset()
            for ds in batches:
                k_fwd, k_prep, k_loss = random.split(
                    random.fold_in(base, it), 3)
                with torch.no_grad():
                    feats, _, _ = self._forward(
                        self.params, self.state,
                        self._as_tensor(ds.features, dtype), None,
                        train=False, rng=k_fwd, upto=idx)
                    prep = self.conf.preprocessors.get(idx)
                    if prep is not None:
                        feats = prep.forward(feats, rng=k_prep)
                leaves = {n: t.detach().requires_grad_(True)
                          for n, t in self.params[key].items()}
                with torch.enable_grad():
                    loss = loss_fn(leaves, feats, k_loss).mean()
                    gs = torch.autograd.grad(loss, list(leaves.values()),
                                             allow_unused=True)
                grads = {key: {n: torch.zeros_like(t) if g is None else g
                               for (n, t), g in zip(leaves.items(), gs)}}
                with torch.no_grad():
                    p_layer = {key: self.params[key]}
                    grads = add_regularization_grads(self, p_layer, grads)
                    steps, opt_state = updater.step(grads, opt_state, it)
                    self.params[key] = {n: t - steps[key][n]
                                        for n, t in p_layer[key].items()}
                losses.append(loss.detach())
                it += 1
        return losses

    @torch.inference_mode()
    def rnn_time_step(self, x):
        """Streaming inference with persistent state (JAX
        ``rnn_time_step``): each call consumes the next chunk of steps (a
        2-D input is one step), carrying the recurrent layers' h/c and the
        attention layers' KV caches to the next call;
        ``rnn_clear_previous_state`` starts a new stream."""
        x = self._as_tensor(x, getattr(torch, self.conf.dtype))
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        carry = self._stream_advance(x.shape[0], x.shape[1])
        out, new_carry, _ = self._forward(self.params, self.state, x, None,
                                          carry=carry)
        self._rnn_state = new_carry
        return out[:, 0] if squeeze and out.dim() == 3 else out
