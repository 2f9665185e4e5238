"""Numerical-health guard and host-side recovery (port of
``deeplearning4j_tpu/optimize/health.py``).

- **Device side** (``all_finite``, ``tree_select``, used by
  ``optimize.fused_fit.build_step_core(guarded=True)``): one all-finite
  reduction over the loss and the gradients per step; when it fails, the
  identity update is selected with ``torch.where`` on the device (params,
  updater state, layer state and carry pass through unchanged), so the
  other steps of a fused block stay good. Nothing syncs inside a block:
  the per-step skip flags come back with the block's stacked losses, in
  one fetch. A device fault (a CUDA error, a kernel refusing a case) is
  not a non-finite value: it propagates.
- **Host side** (``HealthPolicy``): consumes per-block (scores, skips) and
  walks an escalating ladder: an EMA loss-spike detector and a
  consecutive-skip threshold trigger (1) a learning-rate backoff through
  the updater's ``scale_lr``, then (2) a rollback to the newest
  healthy-gated checkpoint of an ``elastic.CheckpointStore``, then (3)
  ``DivergenceError`` after ``max_recoveries``. A quantized net has no
  rollback rung (``save_model`` refuses its int8 tree, so the store holds
  nothing for it): its ladder skips and backs off, then raises
  ``DivergenceError`` as a policy with no store does.

``fit`` turns it on by default (``health_guard=True``); ``None``/``False``
turn it off. Every report goes to the listeners' ``on_health`` and to the
metrics registry under the JAX package's names. A skipped step reports its
raw (non-finite) loss: the guard protects the weights, not the telemetry.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch.metrics.registry import global_registry


class DivergenceError(RuntimeError):
    """Training diverged and the recovery ladder is exhausted."""


# ---------------------------------------------------------- device helpers
def all_finite(loss, grads) -> torch.Tensor:
    """0-d bool tensor on the loss's device: the loss and every gradient
    leaf are all finite (no host sync)."""
    oks = [torch.isfinite(loss).all()]
    for p in grads.values():
        for g in p.values():
            oks.append(torch.isfinite(g).all())
    return torch.stack(oks).all()


def tree_select(ok, new, old):
    """``new`` where ``ok`` else ``old``, leaf by leaf over nested dicts of
    tensors. When the structures differ (a carry seeded from ``{}``) there
    is nothing to pass through: ``new``."""
    if not _same_structure(new, old):
        return new
    return _select(ok, new, old)


def _same_structure(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same_structure(a[k], b[k]) for k in a)
    return not isinstance(b, dict)


def _select(ok, new, old):
    if isinstance(new, dict):
        return {k: _select(ok, new[k], old[k]) for k in new}
    return torch.where(ok, new, old)


# ------------------------------------------------------------- host policy
class HealthPolicy:
    """Host-side recovery policy over per-block (score, skipped) streams.

    Recovery ladder, walked once per trigger (consecutive-skip threshold or
    EMA loss spike), bounded by ``max_recoveries``:

    1. LR backoff: ``net.conf.updater.scale_lr(lr_backoff)``, and the net's
       cached step functions dropped (their per-layer LR multipliers are
       relative to the base rate);
    2. rollback: params, updater state, layer state and iteration restored
       in place, on the net's device, from the newest checkpoint in
       ``store`` (healthy-gated by this policy's own saves); the
       backed-off LR is kept;
    3. ``DivergenceError`` once ``max_recoveries`` is spent (or when no
       rung is available).

    Periodic saves: every ``save_frequency`` iterations, IF the window
    since the previous save opportunity saw no skipped step.
    """

    def __init__(self, *, store=None, save_frequency: int = 100,
                 skip_threshold: int = 8, spike_factor: float = 10.0,
                 ema_alpha: float = 0.1, warmup_steps: int = 20,
                 lr_backoff: Optional[float] = 0.5,
                 max_recoveries: int = 3, registry=None):
        if lr_backoff is not None and not 0.0 < lr_backoff < 1.0:
            raise ValueError(
                f"lr_backoff must be in (0, 1) or None, got {lr_backoff}")
        if skip_threshold < 1:
            raise ValueError("skip_threshold must be >= 1")
        self.store = store
        self.save_frequency = int(save_frequency)
        self.skip_threshold = int(skip_threshold)
        self.spike_factor = float(spike_factor)
        self.ema_alpha = float(ema_alpha)
        self.warmup_steps = int(warmup_steps)
        self.lr_backoff = lr_backoff
        self.max_recoveries = int(max_recoveries)
        self.ema: Optional[float] = None
        self.warmup_seen = 0
        self.consecutive_skips = 0
        self.total_skips = 0
        self.recoveries = 0
        self.skips_in_window = 0
        self.events: list = []
        self._window_start: Optional[int] = None
        self.metrics = registry if registry is not None \
            else global_registry()
        self._m_events = self.metrics.counter(
            "health_events_total", "health-guard reports by action",
            labels=("action",))
        self._m_ema = self.metrics.gauge(
            "health_loss_ema", "EMA loss baseline of the spike detector")
        self._m_consecutive = self.metrics.gauge(
            "health_consecutive_skips", "current consecutive skipped steps")
        self._m_total_skips = self.metrics.gauge(
            "health_total_skips", "total device-skipped steps")
        self._m_recoveries = self.metrics.gauge(
            "health_recoveries", "recovery-ladder rungs walked")

    # ------------------------------------------------------------- binding
    def bind(self, net) -> "HealthPolicy":
        """Attach to a fit loop."""
        return self

    def healthy_to_save(self) -> bool:
        """Gate for external checkpointers (``elastic.CheckpointListener``):
        True iff no step was skipped in the current save window."""
        return self.skips_in_window == 0 and self.consecutive_skips == 0

    # --------------------------------------------------------- observation
    def observe(self, net, scores, skips, it0: Optional[int] = None):
        """Consume one block of per-iteration (score, skipped) host values
        (K of each fused, 1 unfused). May back off the LR or roll the net
        back, and raises ``DivergenceError`` when the ladder is spent."""
        scores = np.atleast_1d(np.asarray(scores, np.float64))
        skips = np.atleast_1d(np.asarray(skips, np.float64))
        if self._window_start is None:
            self._window_start = (it0 if it0 is not None
                                  else net.iteration - len(scores))
        block_skips = 0
        spike_score = None
        for s, sk in zip(scores, skips):
            if sk > 0:
                block_skips += 1
                self.total_skips += 1
                self.consecutive_skips += 1
                continue
            self.consecutive_skips = 0
            if not np.isfinite(s):
                continue
            if (spike_score is None and self.ema is not None
                    and self.warmup_seen >= self.warmup_steps
                    and self.ema > 0
                    and s > self.spike_factor * self.ema):
                # a spike triggers recovery and must not drag the EMA
                # baseline up toward itself
                spike_score = float(s)
                continue
            a = self.ema_alpha
            self.ema = (float(s) if self.ema is None
                        else (1.0 - a) * self.ema + a * float(s))
            self.warmup_seen += 1
        self.skips_in_window += block_skips
        if block_skips:
            self._emit(net, {
                "action": "skip", "reason": "nonfinite",
                "iteration": net.iteration,
                "skipped_in_block": block_skips,
                "consecutive_skips": self.consecutive_skips,
                "total_skips": self.total_skips,
            })
        recovered = False
        if self.consecutive_skips >= self.skip_threshold:
            self.recover(net, "skip_threshold",
                         {"consecutive_skips": self.consecutive_skips})
            recovered = True
        elif spike_score is not None:
            self.recover(net, "loss_spike",
                         {"score": spike_score, "ema": self.ema})
            recovered = True
        # healthy-gated periodic checkpoint: an unhealthy window is dropped
        # (no save) and the window restarts
        if (not recovered and self.store is not None
                and net.iteration - self._window_start
                >= self.save_frequency):
            if self.skips_in_window == 0:
                self.store.save(net, {"healthy": True,
                                      "total_skips": self.total_skips})
            self._window_start = net.iteration
            self.skips_in_window = 0

    # ------------------------------------------------------------ recovery
    def recover(self, net, reason: str, detail: dict):
        """Walk one rung of the ladder; raises ``DivergenceError`` when the
        retries are spent or no rung is available."""
        self.recoveries += 1
        self.consecutive_skips = 0
        report = {"reason": reason, "iteration": net.iteration,
                  "recoveries": self.recoveries,
                  "total_skips": self.total_skips, **detail}
        if self.recoveries > self.max_recoveries:
            self._emit(net, {**report, "action": "raise"})
            raise DivergenceError(
                f"training diverged ({reason} at iteration "
                f"{net.iteration}) and the recovery ladder is exhausted "
                f"after {self.max_recoveries} recoveries "
                f"({self.total_skips} steps skipped in total)")
        if self.recoveries == 1 and self.lr_backoff is not None:
            done = self._do_backoff(net, report)
        else:
            done = (self._do_rollback(net, report)
                    or (self.lr_backoff is not None
                        and self._do_backoff(net, report)))
        if not done:
            self._emit(net, {**report, "action": "raise"})
            raise DivergenceError(
                f"training diverged ({reason} at iteration "
                f"{net.iteration}) and no recovery rung is available "
                "(lr_backoff disabled and no checkpoint to roll back to)")
        # a fresh spike baseline after any recovery
        self.ema = None
        self.warmup_seen = 0

    def _do_backoff(self, net, report: dict) -> bool:
        updater = getattr(net.conf, "updater", None)
        if updater is None or not getattr(updater, "learning_rate", None):
            return False
        lr_before = updater.learning_rate
        lr_after = updater.scale_lr(self.lr_backoff)
        self._invalidate_programs(net)
        self._emit(net, {**report, "action": "lr_backoff",
                         "lr_before": lr_before, "lr_after": lr_after})
        return True

    def _do_rollback(self, net, report: dict) -> bool:
        if self.store is None:
            return False
        restored = self.store.restore(device=getattr(net, "device", None))
        if restored is None:
            return False
        ckpt, meta = restored
        # in-place rewind: the live net keeps its conf (and so the
        # backed-off LR) and listeners; only the trajectory state rewinds
        net.params = ckpt.params
        net.updater_state = ckpt.updater_state
        net.state = ckpt.state
        net.iteration = ckpt.iteration
        self._window_start = net.iteration
        self.skips_in_window = 0
        self._emit(net, {**report, "action": "rollback",
                         "restored_iteration": net.iteration,
                         "checkpoint_meta": meta})
        return True

    def _invalidate_programs(self, net):
        cache = getattr(net, "_step_cache", None)
        if cache is not None:
            cache.clear()

    # -------------------------------------------------------------- events
    def _emit(self, net, report: dict):
        self.events.append(report)
        self._m_events.labels(action=report.get("action", "unknown")).inc()
        self._m_ema.set(self.ema if self.ema is not None else 0.0)
        self._m_consecutive.set(self.consecutive_skips)
        self._m_total_skips.set(self.total_skips)
        self._m_recoveries.set(self.recoveries)
        for listener in getattr(net, "listeners", []) or []:
            hook = getattr(listener, "on_health", None)
            if hook is not None:
                hook(net, dict(report))


def resolve_health_policy(health_guard) -> Optional[HealthPolicy]:
    """``fit(health_guard=...)``: True -> a default policy, None/False ->
    guard off, a HealthPolicy -> itself."""
    if health_guard is None or health_guard is False:
        return None
    if health_guard is True:
        return HealthPolicy()
    if isinstance(health_guard, HealthPolicy):
        return health_guard
    raise TypeError(
        "health_guard must be True (default policy), None/False (guard "
        f"off), or a HealthPolicy instance; got {health_guard!r}")
