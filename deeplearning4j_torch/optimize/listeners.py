"""Training listeners (port of ``deeplearning4j_tpu/optimize/listeners.py``).

Block semantics under the fused fit (``optimize/fused_fit.py``): a block of
K steps runs with no host sync, so scores come back per BLOCK, in one fetch
of the stacked losses. ``iteration_done`` still fires once per iteration
(with ``model.score_value`` set to that iteration's score), but the
parameters a hook sees are the END-OF-BLOCK parameters. Listeners that want
the whole stacked score array override ``on_block_done``.

``EvaluativeListener`` evaluates the net on a held-out iterator every N
iterations. ``ProfilerListener`` records a ``torch.profiler`` trace of a
window of iterations into a Chrome trace file.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

log = logging.getLogger(__name__)


class TrainingListener:
    """Base listener. Subclasses override any subset of hooks."""

    def iteration_done(self, model, iteration: int):
        pass

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def on_block_done(self, model, iterations: list, scores):
        """Fired once per fused K-step block, BEFORE the block's
        ``iteration_done`` calls: ``iterations`` the iteration numbers it
        ran, ``scores`` the matching numpy losses (one fetch for the block).
        ``model`` carries end-of-block parameters."""
        pass

    def on_phase_timings(self, model, timings: dict):
        """Per-round training-phase wall times (reference:
        spark/api/stats/SparkTrainingStats.java — data-fetch / fit /
        aggregation timings per worker round), from ``ParallelWrapper``.
        ``timings`` carries ms floats, e.g. {"host_prep_ms": ...,
        "device_round_ms": ...}."""
        pass

    def on_health(self, model, report: dict):
        """Fired by the numerical-health guard (``optimize/health.py``) when
        it sees skipped (non-finite) steps or takes a recovery action.
        ``report["action"]`` is ``"skip"``, ``"lr_backoff"``,
        ``"rollback"`` or ``"raise"``; the other keys carry the trigger
        (``reason``), the iteration and the action's detail."""
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every N iterations."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration: int):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration,
                     model.score_value)


class PerformanceListener(TrainingListener):
    """Throughput (iterations/s, and examples/s given ``batch_size``) every
    N iterations."""

    def __init__(self, frequency: int = 10, report_batch: bool = True):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self.last_samples_per_sec: Optional[float] = None
        self.batch_size: int = 0

    def iteration_done(self, model, iteration: int):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0 and iters > 0:
                it_per_sec = iters / dt
                self.last_samples_per_sec = it_per_sec * self.batch_size
                log.info("iteration %d: %.1f iter/s, %.1f samples/s",
                         iteration, it_per_sec,
                         self.last_samples_per_sec or 0.0)
            self._last_time = now
            self._last_iter = iteration
        elif self._last_time is None:
            self._last_time = now
            self._last_iter = iteration


class CollectScoresIterationListener(TrainingListener):
    """Collect (iteration, score) pairs every N iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: list = []

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))


class EvaluativeListener(TrainingListener):
    """Evaluate on a held-out iterator every N iterations
    (``model.evaluate``): each ``(iteration, Evaluation)`` is kept in
    ``evaluations`` and handed to ``callback(model, ev)``, else logged."""

    def __init__(self, eval_iterator, frequency: int = 100, callback=None):
        self.eval_iterator = eval_iterator
        self.frequency = max(1, frequency)
        self.callback = callback
        self.evaluations: list = []

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency == 0:
            ev = model.evaluate(self.eval_iterator)
            self.evaluations.append((iteration, ev))
            if self.callback:
                self.callback(model, ev)
            else:
                log.info("Eval at iter %d: accuracy=%.4f f1=%.4f", iteration,
                         ev.accuracy(), ev.f1())


class TimeIterationListener(TrainingListener):
    """Log an estimate of the remaining time every N iterations."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total_iterations = total_iterations
        self.frequency = max(1, frequency)
        self._start = time.perf_counter()

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = elapsed / iteration
            remaining = (self.total_iterations - iteration) * rate
            log.info("iteration %d/%d, ~%.0fs remaining", iteration,
                     self.total_iterations, remaining)


class ProfilerListener(TrainingListener):
    """Profile a window of iterations: the trace starts at the first
    ``iteration_done`` with ``start_iteration <= iteration <
    start_iteration + num_iterations`` and stops at the first one past the
    window (JAX's window logic). ``torch.profiler`` records CPU activity,
    and CUDA activity (kernels, copies) when the net is on a card; the
    trace is written to ``log_dir`` as a Chrome trace,
    ``trace_<start>_<stop>.json`` (``trace_path`` once written), openable
    in Perfetto or ``chrome://tracing``."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 num_iterations: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.stop_iteration = start_iteration + num_iterations
        self._active = False
        self._prof = None
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration: int):
        import torch

        if not self._active and self.start_iteration <= iteration \
                < self.stop_iteration:
            acts = [torch.profiler.ProfilerActivity.CPU]
            dev = getattr(model, "device", None)
            if dev is not None and dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._active = True
        elif self._active and iteration >= self.stop_iteration:
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, f"trace_{self.start_iteration}"
                                f"_{self.stop_iteration}.json")
            self._prof.export_chrome_trace(path)
            self.trace_path = path
            self._active = False
            log.info("profiler trace written to %s", path)


class HealthListener(TrainingListener):
    """Collect (and optionally log) the health guard's reports: skipped
    non-finite steps, LR backoffs, rollbacks; ``reports`` holds every
    event dict in order."""

    def __init__(self, log_events: bool = True):
        self.reports: list = []
        self.log_events = log_events

    def on_health(self, model, report: dict):
        self.reports.append(report)
        if self.log_events:
            log.warning("health event at iteration %s: %s",
                        report.get("iteration"), report)


class ModelSavingCallback(TrainingListener):
    """Save the model zip every N iterations to
    ``path_template.format(iteration=...)``."""

    def __init__(self, path_template: str, frequency: int = 1000):
        self.path_template = path_template
        self.frequency = max(1, frequency)

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency == 0:
            from deeplearning4j_torch.utils.model_serializer import save_model

            save_model(model, self.path_template.format(iteration=iteration))
