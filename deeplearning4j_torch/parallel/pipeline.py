"""Pipeline parallelism: GPipe-style microbatch training over layer stages
(port of ``deeplearning4j_tpu/parallel/pipeline.py``).

A MultiLayerNetwork's layers split into contiguous STAGES; stage s's
parameters, updater state and layer state live on device s of the
trainer's list (a mesh entry each), and a minibatch goes through as M
microbatches:

- **Host-scheduled stages.** One process enqueues the whole forward
  schedule; each stage's work runs on its own device, and the activations
  move between stages with ``.to()``. Heterogeneous stages (a conv stem,
  a dense head) need nothing uniform.
- **Recompute backward.** Only each stage's INPUT per microbatch is
  stashed; the backward recomputes the stage forward from the stash under
  autograd and pulls the cotangent through it (the GPipe paper's memory
  trick, as JAX's ``do_step`` recomputes inside ``jax.vjp``).
- **Parity.** With equal microbatches, the summed per-microbatch
  gradients of per-microbatch mean losses divided by M equal the
  full-batch mean-loss gradient, so training matches one device up to
  float order. The updater takes the 0-based iteration (Adam's t =
  iteration + 1), as ``do_step`` does.

Layer state (batch-norm running statistics) is refreshed from the last
microbatch's forward with the updated parameters, the last stage's body
layers included. Dropout keys are ``fold_in(fold_in(PRNGKey(seed),
iteration), m * S + s)`` per (microbatch, stage), as JAX's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_torch.ops import random
from deeplearning4j_torch.parallel.mesh import replicate, tree_map


def balanced_stages(net, n_stages: int) -> List[List[int]]:
    """Split layer indices into contiguous stages balanced by parameter
    count (the pipeline's load balance is set by its slowest stage)."""
    sizes = [sum(int(t.numel()) for t in net.params[str(i)].values()) + 1
             for i in range(len(net.layers))]
    total = sum(sizes)
    target = total / n_stages
    stages, cur, acc = [], [], 0.0
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += s
        remaining_layers = len(sizes) - i - 1
        remaining_stages = n_stages - len(stages) - 1
        if (acc >= target and remaining_stages > 0) or \
                remaining_layers == remaining_stages > 0:
            stages.append(cur)
            cur, acc = [], 0.0
    if cur:
        stages.append(cur)
    return stages


def _tadd(a, b):
    if isinstance(a, dict):
        return {k: _tadd(a[k], b[k]) for k in a}
    return a + b


class PipelineTrainer:
    """Train a MultiLayerNetwork over ``n_stages`` devices with ``n_micro``
    microbatches per step (DL4J has no pipeline parallelism). ``devices``:
    one per stage (default the first CUDA devices; a mesh may name one
    card several times)."""

    def __init__(self, net, n_stages: int = 2, n_micro: int = 4,
                 devices: Optional[list] = None):
        if devices is None:
            from deeplearning4j_torch.parallel.mesh import local_devices

            devices = local_devices()[:n_stages]
        if len(devices) < n_stages:
            raise ValueError(f"need {n_stages} devices, have {len(devices)}")
        self.net = net
        self.n_micro = n_micro
        self.devices = [torch.device(d) for d in devices[:n_stages]]
        self.stages = balanced_stages(net, n_stages)
        self.updater = net.conf.updater
        self._params, self._states, self._opt = [], [], []
        for s, idxs in enumerate(self.stages):
            dev = self.devices[s]
            p = {str(i): {n: t.to(dev, copy=True)
                          for n, t in net.params[str(i)].items()}
                 for i in idxs}
            st = {str(i): replicate(net.state.get(str(i), {}), dev,
                                    copy=True) for i in idxs}
            self._params.append(p)
            self._states.append(st)
            self._opt.append(self.updater.init(p))
        full = net._lr_mult_tree()
        self._lr = [None if full is None else
                    {str(i): full[str(i)] for i in idxs}
                    for idxs in self.stages]
        self.iteration = 0
        self.score_value = float("nan")

    # ---------------------------------------------------------- stage math
    def _apply_layers(self, idxs, params, state, x, rng):
        """The ONE stage-body forward shared by the forward, the loss and
        the recompute backward: preprocessors + layer forwards over
        ``idxs``, the key split once per layer (so the recompute sees the
        forward's dropout masks)."""
        from deeplearning4j_torch.nn.conf.preprocessors import (
            preprocessor_key)

        conf = self.net.conf
        new_state = {}
        keys = (random.split(rng, max(len(idxs), 1)) if rng is not None
                else [None] * len(idxs))
        for j, i in enumerate(idxs):
            k = None if rng is None else keys[j]
            layer = self.net.layers[i]
            if i in conf.preprocessors:
                x = conf.preprocessors[i].forward(x, rng=preprocessor_key(k))
            x, ns = layer.forward(params[str(i)], state.get(str(i), {}), x,
                                  train=True, rng=k)
            new_state[str(i)] = ns
        return x, new_state

    def _stage_reg(self, s, params):
        """This stage's share of the L1/L2 penalty value (the gradient is
        the closed form, added by ``_add_stage_reg_grads``)."""
        reg = 0.0
        with torch.no_grad():
            for i in self.stages[s]:
                reg = reg + self.net.layers[i].regularization(params[str(i)])
        return reg

    def _add_stage_reg_grads(self, s, params, dp):
        for i in self.stages[s]:
            sub = params.get(str(i), {})
            for k, g in self.net.layers[i].regularization_grad(sub).items():
                dp[str(i)][k] = dp[str(i)][k] + g
        return dp

    def _stage_has_reg(self, s):
        return any(getattr(self.net.layers[i], f, None)
                   for i in self.stages[s]
                   for f in ("l1", "l2", "l1_bias", "l2_bias"))

    def _is_last(self, s):
        return s == len(self.stages) - 1

    def _last_stage_loss(self, s, params, state, x, y, rng):
        from deeplearning4j_torch.nn.conf.preprocessors import (
            preprocessor_key)

        out_idx = self.stages[s][-1]
        conf = self.net.conf
        x, new_state = self._apply_layers(self.stages[s][:-1], params,
                                          state, x, rng)
        if out_idx in conf.preprocessors:
            x = conf.preprocessors[out_idx].forward(
                x, rng=preprocessor_key(rng))
        loss = torch.mean(self.net.layers[out_idx].compute_loss_per_example(
            params[str(out_idx)], x, y))
        return loss + self._stage_reg(s, params), new_state

    def _leaves(self, params):
        return {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
                for k, v in params.items()}

    def _grads(self, leaves, gs):
        it = iter(gs)
        return {k: {n: (torch.zeros_like(t) if (g := next(it)) is None
                        else g) for n, t in v.items()}
                for k, v in leaves.items()}

    def _bwd_last(self, s, x, y, rng):
        leaves = self._leaves(self._params[s])
        xx = x.detach().requires_grad_(True)
        flat = [t for v in leaves.values() for t in v.values()]
        with torch.enable_grad():
            loss, _ = self._last_stage_loss(s, leaves, self._states[s], xx,
                                            y, rng)
            gs = torch.autograd.grad(loss, flat + [xx], allow_unused=True)
        dp = self._add_stage_reg_grads(s, self._params[s],
                                       self._grads(leaves, gs[:-1]))
        return loss.detach(), dp, gs[-1]

    def _bwd(self, s, x, dy, rng):
        """Recompute-forward backward: only the stage INPUT was stashed."""
        leaves = self._leaves(self._params[s])
        xx = x.detach().requires_grad_(True)
        flat = [t for v in leaves.values() for t in v.values()]
        with torch.enable_grad():
            y, _ = self._apply_layers(self.stages[s], leaves,
                                      self._states[s], xx, rng)
            gs = torch.autograd.grad(y, flat + [xx], grad_outputs=dy,
                                     allow_unused=True)
        dp = self._grads(leaves, gs[:-1])
        if self._stage_has_reg(s):
            # the penalty does not flow through dy: its closed form is
            # added locally, as one device adds it to the loss
            dp = self._add_stage_reg_grads(s, self._params[s], dp)
        return dp, gs[-1]

    def _update(self, s, grads, iteration):
        from deeplearning4j_torch.nn.gradient_normalization import (
            apply_gradient_normalization)

        layer_map = {str(i): self.net.layers[i] for i in self.stages[s]}
        grads = apply_gradient_normalization(layer_map, grads)
        if self._lr[s] is not None:
            steps, self._opt[s] = self.updater.step(grads, self._opt[s],
                                                    iteration, self._lr[s])
        else:
            steps, self._opt[s] = self.updater.step(grads, self._opt[s],
                                                    iteration)
        self._params[s] = {k: {n: t - steps[k][n] for n, t in v.items()}
                           for k, v in self._params[s].items()}

    # ---------------------------------------------------------------- step
    def _microbatches(self, x, y):
        B = x.shape[0]
        if B % self.n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro "
                             f"{self.n_micro}")
        m = B // self.n_micro
        return [(x[i * m:(i + 1) * m], y[i * m:(i + 1) * m])
                for i in range(self.n_micro)]

    def _rng(self, m, s):
        """Per-(microbatch, stage) dropout key (None when nothing draws)."""
        if self.net._step_rng(self.iteration) is None:
            return None
        base = random.fold_in(random.PRNGKey(self.net.conf.seed,
                                             device=self.devices[s]),
                              self.iteration)
        return random.fold_in(base, m * len(self.stages) + s)

    def do_step(self, x, y) -> float:
        dtype = getattr(torch, self.net.conf.dtype)
        x = torch.as_tensor(np.asarray(x), dtype=dtype)
        y = torch.as_tensor(np.asarray(y), dtype=dtype)
        micros = self._microbatches(x, y)
        S = len(self.stages)
        # forward schedule: each stage's INPUT per microbatch is stashed
        stash = [[None] * S for _ in range(self.n_micro)]
        with torch.no_grad():
            for m, (xm, ym) in enumerate(micros):
                a = xm.to(self.devices[0])
                for s in range(S - 1):
                    stash[m][s] = a
                    a, _ = self._apply_layers(self.stages[s],
                                              self._params[s],
                                              self._states[s], a,
                                              self._rng(m, s))
                    a = a.to(self.devices[s + 1])
                stash[m][S - 1] = (a, ym.to(self.devices[S - 1]))
        # backward schedule: per microbatch from the loss stage down,
        # accumulating each stage's gradients on its own device
        grads = [None] * S
        losses = []
        for m in range(self.n_micro):
            a, ym = stash[m][S - 1]
            loss, dp, dx = self._bwd_last(S - 1, a, ym,
                                          self._rng(m, S - 1))
            losses.append(loss)
            grads[S - 1] = dp if grads[S - 1] is None else _tadd(
                grads[S - 1], dp)
            dy = dx
            for s in range(S - 2, -1, -1):
                dp, dx = self._bwd(s, stash[m][s], dy.to(self.devices[s]),
                                   self._rng(m, s))
                grads[s] = dp if grads[s] is None else _tadd(grads[s], dp)
                dy = dx
        # sum of per-microbatch mean-loss grads / M == full-batch mean grad
        inv_m = 1.0 / self.n_micro
        with torch.no_grad():
            for s in range(S):
                self._update(s, tree_map(lambda t: t * inv_m, grads[s]),
                             self.iteration)
            # refresh layer states from the last microbatch's forward with
            # the updated params, the last stage's body layers included
            for s in range(S - 1):
                _, self._states[s] = self._apply_layers(
                    self.stages[s], self._params[s], self._states[s],
                    stash[-1][s], self._rng(self.n_micro - 1, s))
            a, ym = stash[-1][S - 1]
            _, ns = self._last_stage_loss(S - 1, self._params[S - 1],
                                          self._states[S - 1], a, ym,
                                          self._rng(self.n_micro - 1, S - 1))
            self._states[S - 1].update(ns)
        self.iteration += 1
        self.score_value = float(torch.stack(
            [l_.to(losses[0].device) for l_ in losses]).mean())
        return self.score_value

    def fit(self, data, epochs: int = 1) -> "PipelineTrainer":
        from deeplearning4j_torch.datasets.dataset import DataSet

        for _ in range(epochs):
            if isinstance(data, DataSet):
                self.do_step(data.features, data.labels)
            else:
                if hasattr(data, "reset"):
                    data.reset()
                for ds in data:
                    self.do_step(ds.features, ds.labels)
        self._sync_back()
        return self

    # ------------------------------------------------------------- plumbing
    def _sync_back(self):
        """Write the stages' params and state back into the wrapped net on
        its device (so output/evaluate/serialization see them)."""
        dev = self.net.device
        for s, idxs in enumerate(self.stages):
            for i in idxs:
                self.net.params[str(i)] = {
                    n: t.to(dev) for n, t in self._params[s][str(i)].items()}
                if self._is_last(s) and i == idxs[-1]:
                    continue
                if str(i) in self._states[s]:
                    self.net.state[str(i)] = replicate(
                        self._states[s][str(i)], dev)
        self.net.iteration = self.iteration
        self.net.score_value = self.score_value
