"""The training step core and the fused K-step fit driver (port of
``deeplearning4j_tpu/optimize/fused_fit.py``).

- ``build_step_core``: one functional step over a net's ``_loss`` (a
  MultiLayerNetwork's or a ComputationGraph's): the gradient of the loss
  with respect to the parameter leaves (autograd on detached copies marked
  ``requires_grad``, as ``jax.value_and_grad`` leaves the parameters plain
  tensors), then the closed-form L1/L2 gradients, then ``grad_transform``,
  then the finite check (guarded), then gradient normalization, then the
  updater with the per-layer learning-rate multipliers, then ``params -
  steps``, then the center update of ``CenterLossOutputLayer`` heads; in
  JAX's order. Guarded, a non-finite step selects the identity update on
  the device.
- ``build_fused_step``: K steps of that core in one call, each on its own
  microbatch with the key ``fold_in(PRNGKey(seed), iteration)`` (the
  iteration advances on a skipped step too), with no host sync inside. In
  eager PyTorch a block runs the very operations the K unfused steps run,
  so its result is theirs bit for bit.
- ``FusedFitDriver``: host-side block assembly. Only FULL K-blocks are
  fused; a trailing group of fewer than K batches takes the per-minibatch
  path. Undersized batches are padded up to the bucket's batch size by
  repeating the last row, with zeroed label-mask rows (a label mask of
  ones is made for unmasked streams), so the masked loss and its gradients
  are those of the unpadded batch. One host fetch of the stacked losses
  (and skip flags) per block; listeners' ``on_block_done`` gets them.
- ``device_put_ahead``: the next block's host-to-device copy is issued
  ``non_blocking`` from pinned memory while the current block trains (a
  plain ``from_numpy`` on the CPU).

CUDA-graph capture of a block and a multi-tensor updater are ROADMAP A4.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from deeplearning4j_torch.nn.gradient_normalization import (
    apply_gradient_normalization, layer_map_for)
from deeplearning4j_torch.nn.regularization import add_regularization_grads
from deeplearning4j_torch.ops import random

#: K for ``fit(..., fused_steps=None)`` on a CUDA net; ``fused_steps=1``
#: opts out (the per-minibatch ``do_step``)
DEFAULT_FUSED_STEPS = 4

#: K for a net on the CPU (the JAX package's CPU default)
DEFAULT_FUSED_STEPS_CPU = 2


def resolve_fused_steps(net, fused_steps):
    """The K a fit call runs: ``fused_steps``, or the default for the net's
    device type (where JAX keys on its default backend); 1 under TBPTT."""
    if fused_steps is None:
        dev = getattr(net, "device", None)
        k = (DEFAULT_FUSED_STEPS_CPU if dev is None or dev.type == "cpu"
             else DEFAULT_FUSED_STEPS)
    else:
        k = int(fused_steps)
        if k < 1:
            raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
    if getattr(net.conf, "backprop_type", "standard") == "tbptt":
        return 1
    return k


# --------------------------------------------------------------- step core
def _center_heads(net) -> list:
    """The keys of the net's ``CenterLossOutputLayer`` heads (each needs
    its centers moved after the step, outside the gradient): a
    MultiLayerNetwork's last layer, a graph's output vertices."""
    from deeplearning4j_torch.nn.conf.layers.misc import (
        CenterLossOutputLayer)

    owners = net._param_owners()
    outs = getattr(net.conf, "network_outputs", None) or [
        str(len(net.layers) - 1)]
    return [k for k in outs if isinstance(owners.get(k),
                                          CenterLossOutputLayer)]


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if torch.is_tensor(tree) else tree


def _loss_and_grads(net, params, state, x, y, input_mask, label_mask, *,
                    train, rng, carry):
    leaves = {v: {k: t.detach().requires_grad_(True) for k, t in p.items()}
              for v, p in params.items()}
    flat = [t for p in leaves.values() for t in p.values()]
    with torch.enable_grad():
        loss, aux = net._loss(leaves, state, x, y, input_mask, label_mask,
                              train=train, rng=rng, carry=carry)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    aux = _detached(aux)
    it = iter(gs)
    grads = {}
    for v, p in leaves.items():
        grads[v] = {}
        for k, t in p.items():
            g = next(it)
            grads[v][k] = torch.zeros_like(t) if g is None else g
    return loss.detach(), aux, grads


def value_and_grad(net, params, state, x, y, input_mask=None,
                   label_mask=None, *, train=False, rng=None, carry=None):
    """``(loss, grads)`` of ``net._loss`` at ``params``; ``grads`` has the
    tree shape of ``params`` and ``loss`` is a detached 0-d tensor (the
    data loss plus the reported penalty). ``train``/``rng`` draw the
    training forward's dropout."""
    loss, _, grads = _loss_and_grads(net, params, state, x, y, input_mask,
                                     label_mask, train=train, rng=rng,
                                     carry=carry)
    return loss, grads


def build_step_core(net, *, grad_transform=None, guarded=False):
    """``core(params, opt_state, state, rng, iteration, x, y, input_mask,
    label_mask, carry) -> (new_params, new_opt, new_state, new_carry,
    loss)``; with ``guarded=True`` the tuple gains a trailing ``skip``
    (1.0 on a step whose loss or gradients were not all finite, where the
    params, updater state, layer state and carry pass through unchanged).
    The raw loss is reported either way. On a finite step the select
    returns the new trees exactly, so guarded and unguarded runs are
    bit-identical."""
    from deeplearning4j_torch.optimize.health import all_finite, tree_select

    centers = _center_heads(net)
    owners = net._param_owners()
    updater = net.conf.updater
    lr_mults = net._lr_mult_tree()
    layer_map = layer_map_for(net)

    def core(params, opt_state, state, rng, iteration, x, y, input_mask,
             label_mask, carry):
        loss, (new_states, new_carry, last_in), grads = _loss_and_grads(
            net, params, state, x, y, input_mask, label_mask, train=True,
            rng=rng, carry=carry)
        with torch.no_grad():
            grads = add_regularization_grads(net, params, grads)
            if grad_transform is not None:
                grads = grad_transform(grads)
            if guarded:
                ok = all_finite(loss, grads)
            grads = apply_gradient_normalization(layer_map, grads)
            if lr_mults is not None:
                steps, opt_state2 = updater.step(grads, opt_state, iteration,
                                                 lr_mults)
            else:
                steps, opt_state2 = updater.step(grads, opt_state, iteration)
            new_params = {v: {k: t - steps[v][k] for k, t in p.items()}
                          for v, p in params.items()}
            for key in centers:
                if isinstance(last_in, dict):       # a graph's heads
                    j = net.conf.network_outputs.index(key)
                    xin, yy = last_in[key], y[j]
                else:
                    xin, yy = last_in, y
                new_states[key] = owners[key].update_centers(state[key],
                                                             xin, yy)
            if guarded:
                new_params = tree_select(ok, new_params, params)
                opt_state2 = tree_select(ok, opt_state2, opt_state)
                new_states = tree_select(ok, new_states, state)
                new_carry = tree_select(ok, new_carry, carry)
                skip = 1.0 - ok.to(torch.float32)
                return (new_params, opt_state2, new_states, new_carry, loss,
                        skip)
        return new_params, opt_state2, new_states, new_carry, loss

    return core


def build_fused_step(net, guarded=False, core=None):
    """``fused(params, opt_state, state, base_key, it0, xs, ys, ims, lms) ->
    (params, opt_state, state, losses[K])`` (with ``guarded``, also
    ``skips[K]``): K steps of ``build_step_core`` over ``[K, B, ...]``
    stacks (``ims``/``lms`` may be None), slot k keyed by ``fold_in(
    base_key, it0 + k)`` as the unfused step keys iteration ``it0 + k``;
    no key where no vertex draws (``net._step_rng``). ``core`` replaces
    the net's own step core (the sharded program of
    ``parallel/model_sharding.py`` passes its own)."""
    if core is None:
        core = build_step_core(net, guarded=guarded)

    def fused(params, opt_state, state, base_key, it0, xs, ys, ims, lms):
        losses, skips = [], []
        draws = net._step_rng(it0) is not None
        for k in range(xs.shape[0]):
            it = it0 + k
            rng = random.fold_in(base_key, it) if draws else None
            out = core(params, opt_state, state, rng, it, xs[k], ys[k],
                       None if ims is None else ims[k],
                       None if lms is None else lms[k], None)
            params, opt_state, state = out[0], out[1], out[2]
            losses.append(out[4])
            if guarded:
                skips.append(out[5])
        if guarded:
            return (params, opt_state, state, torch.stack(losses),
                    torch.stack(skips))
        return params, opt_state, state, torch.stack(losses)

    return fused


# ------------------------------------------------------------ host pipeline
def device_put_ahead(items, depth: int, place):
    """Bounded look-ahead placement: keep ``depth`` placed items in flight
    while the consumer works on the current one. A non-blocking copy
    returns at once, so issuing the copies ahead overlaps them with the
    running steps."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    it = iter(items)
    buf: deque = deque()
    try:
        for _ in range(depth):
            buf.append(place(next(it)))
    except StopIteration:
        pass
    while buf:
        nxt = buf.popleft()
        try:
            buf.append(place(next(it)))
        except StopIteration:
            pass
        yield nxt


def _is_t(a):
    return torch.is_tensor(a)


def _concat(parts):
    return torch.cat(parts) if _is_t(parts[0]) else np.concatenate(parts)


class FusedFitDriver:
    """Consumes a stream of DataSets as fused K-step blocks.

    Shape bucketing: the first usable batch fixes the bucket (batch size,
    trailing dims, mask signature). Undersized batches are padded UP to
    the bucket's batch size by repeating the last row, with ZEROED
    label-mask rows. The one case bucketing leaves out is a stream with a
    features mask and no labels mask: a made-up label mask would override
    the propagated features mask, so undersized batches there take the
    per-minibatch path. Batches that do not fit the bucket (MultiDataSet,
    other trailing dims, larger than the bucket) also take it, after the
    pending batches are flushed so the update order is kept.
    """

    def __init__(self, net, fused_steps: int, prefetch_depth: int = 2):
        if fused_steps < 1:
            raise ValueError("fused_steps must be >= 1")
        self.net = net
        self.K = fused_steps
        self.depth = max(1, prefetch_depth)

    # ------------------------------------------------------------- assembly
    def _blocks(self, batches):
        from deeplearning4j_torch.datasets.dataset import DataSet

        bucket = None
        pend: list = []  # (padded arrays, original DataSet) pairs
        for ds in batches:
            item = None
            if isinstance(ds, DataSet) and ds.labels is not None:
                f, y = ds.features, ds.labels
                im, lm = ds.features_mask, ds.labels_mask
                if bucket is None:
                    bucket = (f.shape[0], tuple(f.shape[1:]),
                              tuple(y.shape[1:]), im is not None,
                              lm is not None)
                B, ftail, ltail, has_im, has_lm = bucket
                fits = (tuple(f.shape[1:]) == ftail
                        and tuple(y.shape[1:]) == ltail
                        and (im is not None) == has_im
                        and (lm is not None) == has_lm
                        and f.shape[0] <= B)
                # a made-up label mask must not shadow a features mask
                synth_lm = not has_lm and not has_im
                if fits and (f.shape[0] == B or has_lm or synth_lm):
                    item = self._pad_micro(f, y, im, lm, B, ltail, synth_lm)
            if item is not None:
                pend.append((item, ds))
                if len(pend) == self.K:
                    yield ("block", self._stack([it for it, _ in pend]))
                    pend = []
                continue
            if pend:  # flush before the fallback batch: updates stay ordered
                yield ("tail", [d for _, d in pend])
                pend = []
            yield ("raw", ds)
        if pend:
            yield ("tail", [d for _, d in pend])

    @staticmethod
    def _pad_micro(f, y, im, lm, B, ltail, synth_lm):
        pad = B - f.shape[0]
        if synth_lm or (lm is None and pad):
            shape = (f.shape[0],) + tuple(ltail[:-1])
            lm = (torch.ones(shape, device=f.device) if _is_t(f)
                  else np.ones(shape, np.float32))
        if pad:
            def rep(a):
                return _concat([a, a[-1:].repeat(
                    *((pad,) + (1,) * (a.dim() - 1)))] if _is_t(a)
                    else [a, np.repeat(a[-1:], pad, axis=0)])

            f, y = rep(f), rep(y)
            if im is not None:
                im = rep(im)
            if lm is not None:
                zeros = ((pad,) + tuple(lm.shape[1:]))
                lm = _concat([lm, torch.zeros(zeros, dtype=lm.dtype,
                                              device=lm.device)]
                             if _is_t(lm) else
                             [lm, np.zeros(zeros, lm.dtype)])
        return (f, y, im, lm)

    @staticmethod
    def _stack(items):
        def stack(j):
            if items[0][j] is None:
                return None
            parts = [r[j] for r in items]
            if any(_is_t(p) for p in parts):
                return torch.stack([torch.as_tensor(p) for p in parts])
            return np.stack(parts)

        return (stack(0), stack(1), stack(2), stack(3))

    # ------------------------------------------------------------ execution
    def _place(self, tagged):
        """A block's stacks as tensors on the net's device: numpy stacks go
        through pinned memory as non-blocking copies on CUDA, and are
        wrapped without a copy on the CPU."""
        tag, payload = tagged
        if tag != "block":
            return tagged
        dev = self.net.device
        cuda = dev.type == "cuda"

        def put(a):
            if a is None:
                return None
            if not _is_t(a):
                a = torch.from_numpy(np.ascontiguousarray(a))
                if cuda:
                    a = a.pin_memory()
            return a.to(dev, non_blocking=cuda)

        return ("block", tuple(put(a) for a in payload))

    def fit_stream(self, batches) -> int:
        """Train over one stream of DataSets; returns iterations run."""
        net = self.net
        start = net.iteration
        for tag, payload in device_put_ahead(self._blocks(batches),
                                             self.depth, self._place):
            if tag == "block":
                self._run_block(*payload)
            elif tag == "tail":
                for ds in payload:
                    net._fit_batch(ds)
            else:
                net._fit_batch(payload)
        return net.iteration - start

    def _run_block(self, xs, ys, ims, lms):
        net = self.net
        K = self.K
        health = net._health
        guarded = health is not None
        fused = net._get_step(("fused", K, guarded))
        dtype = getattr(torch, net.conf.dtype)
        xs, ys = xs.to(dtype), ys.to(dtype)
        ims = None if ims is None else ims.to(torch.float32)
        lms = None if lms is None else lms.to(torch.float32)
        it0 = net.iteration
        out = fused(net.params, net.updater_state, net.state,
                    net._rng_base(), it0, xs, ys, ims, lms)
        if guarded:
            net.params, net.updater_state, net.state, losses, skips = out
        else:
            net.params, net.updater_state, net.state, losses = out
        net.iteration += K
        listeners = net.listeners
        if not listeners and not guarded:
            # a device scalar, no host sync
            net.score_value = losses[K - 1]
            return
        if guarded:
            # one fetch for the block: the stacked losses and skip flags.
            # Observe before the listeners, so health-gated checkpointers
            # see this block's skip state
            both = torch.stack([losses.float(), skips]).cpu().numpy()
            scores, skips_h = both[0], both[1]
            health.observe(net, scores, skips_h, it0)
        else:
            scores = losses.float().cpu().numpy()
        if not listeners:
            net.score_value = losses[K - 1]
            return
        iters = list(range(it0 + 1, it0 + K + 1))
        for listener in listeners:
            if hasattr(listener, "on_block_done"):
                listener.on_block_done(net, iters, scores)
        for k, it in enumerate(iters):
            net.score_value = scores[k]
            for listener in listeners:
                listener.iteration_done(net, it)
