"""ParallelWrapper: data-parallel training over the devices of one process
(port of ``deeplearning4j_tpu/parallel/trainer.py``).

Reference semantics reproduced (parallelism/ParallelWrapper.java:53):

- ``AVERAGING`` mode (:148-305): each worker takes ``averaging_frequency``
  local steps on its own replica, then parameters — and optionally the
  updater state (:273-305 averageUpdatersState) — are averaged across
  workers (Nd4j.averageAndPropagate :261), layer state too.
- ``SHARED_GRADIENTS`` mode (:54-69, SymmetricTrainer.java:23-88): the
  gradients are averaged inside every step, between regularization and
  normalization as the JAX package's ``lax.pmean`` hook sits, so every
  replica takes the update of the concatenated batch.

As in DL4J, the W workers are threads, one per device of the mesh's
``data`` axis, each stepping its own replica with the port's
``build_step_core``; the ``pmean`` is ``parallel/mesh.py::pmean`` (summed
in mesh order on the first device, divided by W, written back to every
replica), inside a step through a barrier. Worker w's step at iteration it
draws from ``fold_in(fold_in(fold_in(PRNGKey(seed), iteration0), it), w)``
as JAX's does.

Equivalence contract (TestCompareParameterAveragingSparkVsSingleMachine):
with ``averaging_frequency=1`` and SGD, training on W devices with
per-device batch B equals one device on the concatenated W·B batch, to
float tolerance.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch.ops import random
from deeplearning4j_torch.optimize.fused_fit import build_step_core
from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.parallel.mesh import (data_devices, data_mesh,
                                                pmean, replicate)

AVERAGING = "averaging"
SHARED_GRADIENTS = "shared_gradients"


class _AllReduce:
    """``pmean`` among W worker threads: each deposits its tree, the last
    to arrive averages them in mesh order, and each takes its device's
    copy. A worker that fails aborts the barrier, so no other hangs."""

    def __init__(self, devices):
        self.devices = devices
        self._slots = [None] * len(devices)
        self._out = None
        self.barrier = threading.Barrier(len(devices), action=self._reduce)

    def _reduce(self):
        self._out = pmean(self._slots, self.devices)

    def __call__(self, w: int, tree):
        self._slots[w] = tree
        self.barrier.wait()
        return self._out[w]


class ParallelWrapper:
    """Data-parallel trainer wrapping any net exposing the functional
    contract ``_loss(params, state, x, y, input_mask, label_mask, *, train,
    rng)`` plus ``params / state / updater_state / conf.updater``
    (MultiLayerNetwork and ComputationGraph both qualify). The net lives on
    the first device of the mesh's ``data`` axis (default ``data_mesh(
    workers)``: the CUDA devices)."""

    def __init__(self, net, workers: Optional[int] = None,
                 averaging_frequency: int = 1, mode: str = AVERAGING,
                 average_updaters: bool = True, mesh=None,
                 report_score: bool = True, health_guard=True):
        if mode not in (AVERAGING, SHARED_GRADIENTS):
            raise ValueError(f"Unknown mode '{mode}'")
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        self.net = net
        self.mesh = mesh if mesh is not None else data_mesh(workers)
        self.devices = data_devices(self.mesh)
        if net.device != self.devices[0]:
            raise ValueError(f"the net lives on {net.device}, the mesh's "
                             f"first device is {self.devices[0]}; init the "
                             "net there")
        self.workers = len(self.devices)
        self.averaging_frequency = averaging_frequency
        self.mode = mode
        self.average_updaters = average_updaters
        self.report_score = report_score
        # numerical-health guard (optimize/health.py): the guarded step
        # core skips non-finite worker steps and the policy handles
        # divergence host-side. True -> default policy per fit() call,
        # None/False -> off, or pass a configured HealthPolicy.
        self.health_guard = health_guard
        self._policy = None  # active policy, set for the duration of fit()
        # mid-stream batches whose size didn't match the stream's (dropped
        # with a warning — see fit); genuine trailing partials not counted
        self.dropped_batches = 0
        # last round's phase wall times (SparkTrainingStats analog)
        self.last_phase_timings: dict = {}
        self._core_cache: dict = {}

    # ------------------------------------------------------------------ build
    def _cores(self, guarded: bool):
        """One step core per worker: SHARED_GRADIENTS cores share one
        all-reduce, called by each with its worker index."""
        if guarded not in self._core_cache:
            if self.mode == SHARED_GRADIENTS:
                reduce = _AllReduce(self.devices)
                cores = [build_step_core(
                    self.net, guarded=guarded,
                    grad_transform=lambda g, w=w: reduce(w, g))
                    for w in range(self.workers)]
            else:
                reduce = None
                cores = [build_step_core(self.net, guarded=guarded)] \
                    * self.workers
            self._core_cache[guarded] = (cores, reduce)
        return self._core_cache[guarded]

    def _invalidate_programs(self):
        """Health-policy hook: drop the cached step cores."""
        self._core_cache.clear()

    # -------------------------------------------------------------------- fit
    def fit(self, iterator, epochs: int = 1):
        """Feed W*F minibatches per averaging round (reference:
        ParallelWrapper.fit :409-487 — each worker consumes its own
        minibatches; incomplete final rounds are dropped, matching the
        reference's skip of trailing partial worker groups)."""
        from deeplearning4j_torch.optimize.health import resolve_health_policy

        net = self.net
        need = self.workers * self.averaging_frequency
        expected_batch = None
        with self.health_bound(resolve_health_policy(self.health_guard)):
            for _ in range(epochs):
                for listener in getattr(net, "listeners", []):
                    listener.on_epoch_start(net)
                if hasattr(iterator, "reset"):
                    iterator.reset()
                buf = []
                stream = iter(iterator)
                ds = next(stream, None)
                while ds is not None:
                    nxt = next(stream, None)
                    b = np.shape(ds.features)[0]
                    if expected_batch is None:
                        expected_batch = b
                    if b != expected_batch:
                        # a genuinely-final undersized minibatch is a
                        # trailing partial: skipped silently like trailing
                        # partial worker groups. Any OTHER mismatch is data
                        # the caller expects to train on — count it and warn
                        # instead of silently losing it.
                        if not (nxt is None and b < expected_batch):
                            self.dropped_batches += 1
                            warnings.warn(
                                f"ParallelWrapper dropped a mid-stream "
                                f"minibatch of size {b} (expected "
                                f"{expected_batch}): all non-trailing "
                                f"minibatches must share one batch size "
                                f"({self.dropped_batches} dropped so far)",
                                stacklevel=2)
                        ds = nxt
                        continue
                    buf.append(ds)
                    if len(buf) == need:
                        self._fit_round(buf)
                        buf = []
                    ds = nxt
                # trailing partial group: dropped (reference parity)
                for listener in getattr(net, "listeners", []):
                    listener.on_epoch_end(net)
                if hasattr(net, "epoch"):
                    net.epoch += 1
            return self.net

    @contextlib.contextmanager
    def health_bound(self, policy):
        """``policy`` (or None) active for the rounds run inside: bound to
        the net and exposed on it too, so health-gated checkpoint listeners
        (elastic.CheckpointListener) see it; the net's earlier policy is
        restored on exit."""
        net = self.net
        prev_health = getattr(net, "_health", None)
        self._policy = policy
        if policy is not None:
            policy.bind(net)
            net._health = policy
        try:
            yield
        finally:
            self._policy = None
            if policy is not None:
                net._health = prev_health

    @staticmethod
    def _host(a):
        if torch.is_tensor(a):
            return a.detach().cpu().numpy()
        return np.asarray(a)

    def _fit_round(self, batches):
        """One averaging round from W*F host minibatches."""
        net = self.net
        W, F = self.workers, self.averaging_frequency
        t_prep0 = time.perf_counter()
        has_im = any(b.features_mask is not None for b in batches)
        has_lm = any(b.labels_mask is not None for b in batches)
        if has_im and not all(b.features_mask is not None for b in batches):
            raise ValueError("Mixed masked/unmasked feature batches in one "
                             "averaging round are not supported")
        if has_lm and not all(b.labels_mask is not None for b in batches):
            raise ValueError("Mixed masked/unmasked label batches in one "
                             "averaging round are not supported")

        # [W*F, B, ...] -> [F, W*B, ...]: round-robin assignment of
        # minibatches to workers (batch i goes to worker i % W, the
        # reference's round-robin feeding), so worker w's rows at step f
        # are [w*B, (w+1)*B) of slot f
        def regroup(field):
            a = np.stack([self._host(getattr(b, field)) for b in batches])
            fwb = a.reshape(F, W, *a.shape[1:])
            return torch.from_numpy(np.ascontiguousarray(
                fwb.reshape(F, W * a.shape[1], *a.shape[2:])))

        dtype = getattr(torch, net.conf.dtype)
        xs = regroup("features").to(dtype)
        ys = regroup("labels").to(dtype)
        ims = regroup("features_mask").float() if has_im else None
        lms = regroup("labels_mask").float() if has_lm else None
        B = xs.shape[1] // W
        guarded = self._policy is not None
        cores, reduce = self._cores(guarded)
        it0 = net.iteration
        draws = net._step_rng(it0) is not None
        rng = random.fold_in(net._rng_base(), it0) if draws else None
        t_dev0 = time.perf_counter()

        results = [None] * W
        errors = []

        def worker(w):
            try:
                dev = self.devices[w]
                rows = slice(w * B, (w + 1) * B)
                # a replica of its own: the steps below are functional, so
                # sharing the net's tensors on one device is safe
                params, opt, state = replicate(
                    (net.params, net.updater_state, net.state), dev)
                key = None if rng is None else rng.to(dev)
                losses, skips = [], []
                for f in range(F):
                    it = it0 + f
                    step_rng = (None if key is None else
                                random.fold_in(random.fold_in(key, it), w))
                    out = cores[w](
                        params, opt, state, step_rng, it,
                        xs[f, rows].to(dev), ys[f, rows].to(dev),
                        None if ims is None else ims[f, rows].to(dev),
                        None if lms is None else lms[f, rows].to(dev), None)
                    params, opt, state = out[0], out[1], out[2]
                    losses.append(out[4].float())
                    if guarded:
                        skips.append(out[5])
                results[w] = (params, opt, state, torch.stack(losses),
                              torch.stack(skips) if guarded else None)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)
                if reduce is not None:
                    reduce.barrier.abort()

        threads = [threading.Thread(target=worker, args=(w,),
                                    name=f"parallel-wrapper-{w}")
                   for w in range(1, W)]
        for t in threads:
            t.start()
        worker(0)
        for t in threads:
            t.join()
        if errors:
            if reduce is not None:
                self._core_cache.pop(guarded, None)  # its barrier is broken
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])

        params = [r[0] for r in results]
        opts = [r[1] for r in results]
        states = [r[2] for r in results]
        home = self.devices[:1]
        if self.mode == AVERAGING:
            net.params = pmean(params, home * W)[0]
            net.updater_state = (pmean(opts, home * W)[0]
                                 if self.average_updaters else opts[0])
        else:
            net.params, net.updater_state = params[0], opts[0]
        # persistent layer state (e.g. BN running stats) is averaged like
        # the reference's full-model averaging
        net.state = pmean(states, home * W)[0]
        # [F] losses and skip fractions averaged over the workers
        losses = pmean([r[3] for r in results], home * W)[0]
        skips = (pmean([r[4] for r in results], home * W)[0]
                 if guarded else None)
        net.iteration += F
        listeners = getattr(net, "listeners", [])
        # timings need a device sync; report_score already pays one — as
        # does the guarded round's stats fetch. Only the guard, the score
        # or a listener that consumes phase timings blocks here.
        want_timings = self.report_score or any(
            type(ls).on_phase_timings is not TrainingListener.on_phase_timings
            for ls in listeners)
        scores_h = skips_h = None
        if guarded:
            # ONE small host fetch per round: [F] mean losses and [F] skip
            # fractions together
            scores_h, skips_h = torch.stack([losses, skips]).cpu().numpy()
            if self.report_score:
                net.score_value = float(np.mean(scores_h))
        elif self.report_score:
            net.score_value = float(losses.mean())
        elif want_timings:
            losses.cpu()
        if want_timings:
            t_end = time.perf_counter()
            # per-round phase stats (reference: SparkTrainingStats —
            # data-fetch / fit / aggregation per worker round); the
            # averaging is part of the round, reported with it
            self.last_phase_timings = {
                "host_prep_ms": (t_dev0 - t_prep0) * 1e3,
                "device_round_ms": (t_end - t_dev0) * 1e3,
                "averaging": "in-device-round",
                "round_iterations": F,
                "workers": W,
            }
            for listener in listeners:
                listener.on_phase_timings(net, dict(self.last_phase_timings))
        it_done = net.iteration
        if guarded:
            # may back off the LR, roll back, or raise — BEFORE the
            # listener round, so gated checkpoint listeners see this
            # round's skip state
            self._policy.observe(net, scores_h, skips_h, it0)
        for listener in listeners:
            listener.iteration_done(net, it_done)

    # ------------------------------------------------------------- utilities
    def average_models(self):
        """No-op: the round ends with the averaged model in the net
        (the reference needed an explicit averageModelsParams across its
        replicas)."""
        return self.net
