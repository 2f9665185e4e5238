"""Early stopping over the data-parallel trainer (port of
``deeplearning4j_tpu/parallel/early_stopping.py``; reference:
parallelism/EarlyStoppingParallelTrainer.java — the early-stopping loop
with ParallelWrapper doing each epoch's fitting)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_torch.earlystopping.trainer import EarlyStoppingTrainer
from deeplearning4j_torch.parallel.trainer import ParallelWrapper


class _MeshFitAdapter:
    """Presents ParallelWrapper's round-based fit as the per-DataSet fit the
    early-stopping loop drives; buffers until a full averaging round."""

    def __init__(self, pw: ParallelWrapper):
        self.pw = pw
        self._buf: list = []
        self._expected_batch = None
        # one policy carried across the per-minibatch fit calls, so skip
        # runs / recovery counters span rounds (resolved on first use)
        self._policy = None
        self._policy_src = None

    def fit(self, ds, health_guard=None):
        b = np.shape(ds.features)[0]
        if self._expected_batch is None:
            self._expected_batch = b
        if b != self._expected_batch:
            # undersized trailing minibatch: dropped, matching
            # ParallelWrapper.fit's uniform-batch filter
            return
        self._buf.append(ds)
        need = self.pw.workers * self.pw.averaging_frequency
        if len(self._buf) >= need:
            self._run_round(self._buf[:need], health_guard)
            self._buf = self._buf[need:]

    def _run_round(self, batches, health_guard):
        from deeplearning4j_torch.optimize.health import resolve_health_policy

        pw = self.pw
        if health_guard is not self._policy_src:
            self._policy_src = health_guard
            self._policy = resolve_health_policy(health_guard)
        # ParallelWrapper.fit's binding, scoped to one round
        with pw.health_bound(self._policy):
            pw._fit_round(batches)

    def __getattr__(self, name):
        return getattr(self.pw.net, name)


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    def __init__(self, config, net, train_iterator, mesh=None,
                 workers: Optional[int] = None, averaging_frequency: int = 1,
                 mode: str = "shared_gradients", listener=None,
                 health_guard=None):
        pw = ParallelWrapper(net, mesh=mesh, workers=workers,
                             averaging_frequency=averaging_frequency,
                             mode=mode, health_guard=health_guard)
        super().__init__(config, _MeshFitAdapter(pw), train_iterator,
                         listener=listener, health_guard=health_guard)
        self.wrapper = pw
