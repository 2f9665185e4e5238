"""StatsListener: per-iteration training telemetry into a StatsStorageRouter
(port of ``deeplearning4j_tpu/ui/stats.py``).

Reference: ui-model/.../stats/BaseStatsListener.java:44 (collection loop
:297-381 — score, param/gradient/update norms + histograms, timings, memory,
GC). Gradients never leave the training step, so update norms are computed
from parameter norms between reports (update = |norm_t - norm_{t-1}|), as
in the JAX package; JVM/GC memory becomes host RSS.

The parameters live on the net's device. A report computes every
parameter's L2 norm there and fetches them in ONE transfer; histograms (at
reporting iterations only) take one more transfer of all parameters and
count on the host with ``np.histogram``, so the counts are the JAX
package's for the same arrays. Under the fused fit a report sees the
end-of-block parameters, in both packages (``optimize/listeners.py``).

Every record carries the JAX package's keys, but for the static record's
``jax_backend``, which is ``torch_backend`` here (the device type the net
trains on), and ``devices``, which names torch's devices.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from deeplearning4j_torch.metrics.registry import global_registry
from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.ui.storage import StatsStorageRouter, make_record

TYPE_ID = "StatsListener"


class StatsReport:
    """Convenience view over a stored update record's data dict."""

    def __init__(self, record: dict):
        self.record = record
        self.data = record["data"]

    @property
    def score(self):
        return self.data["score"]

    @property
    def iteration(self):
        return self.data["iteration"]

    def param_norms(self):
        return self.data.get("param_norms", {})

    def update_norms(self):
        return self.data.get("update_norms", {})


def _leaves(params):
    """[('layer/param', tensor)] over a 2-level tree, in its order."""
    return [(f"{lk}/{pk}", v) for lk, lp in params.items()
            for pk, v in lp.items()]


def _flat_norms(params) -> dict:
    """{'layer/param': l2norm}: the norms computed where the parameters
    live, fetched to the host in one transfer."""
    leaves = _leaves(params)
    if not leaves:
        return {}
    norms = torch.stack([_norm(torch.as_tensor(v).detach())
                         for _, v in leaves])
    return {k: float(n) for (k, _), n in zip(leaves, norms.cpu().tolist())}


def _norm(t: torch.Tensor) -> torch.Tensor:
    """L2 norm of ``t`` in at least f32, as an f64 scalar on its device."""
    wide = t.reshape(-1).to(torch.promote_types(t.dtype, torch.float32))
    return torch.linalg.vector_norm(wide).double()


def _host_arrays(params) -> dict:
    """{'layer/param': flat numpy array}: every parameter copied to the
    host in one transfer (the leaves are joined on their device first)."""
    leaves = _leaves(params)
    if not leaves:
        return {}
    flat = [torch.as_tensor(v).detach().reshape(-1) for _, v in leaves]
    dtypes = [t.dtype for t in flat]
    joined = torch.cat(flat).cpu()
    out, s = {}, 0
    for (k, _), t, dt in zip(leaves, flat, dtypes):
        part = joined[s:s + t.numel()]
        s += t.numel()
        # numpy has no bf16: widen it (exactly) to f32
        part = part.to(torch.float32 if dt == torch.bfloat16 else dt)
        out[k] = part.numpy()
    return out


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 — non-linux fallback
        return 0


def _device_names(model) -> tuple:
    """(torch backend, device names) of the device ``model`` trains on."""
    dev = torch.device(getattr(model, "device", None) or "cpu")
    if dev.type == "cuda":
        return "cuda", [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                        for i in range(torch.cuda.device_count())]
    return dev.type, [str(dev)]


class StatsListener(TrainingListener):
    def __init__(self, router: StatsStorageRouter, session_id: str = None,
                 worker_id: str = "worker_0", reporting_frequency: int = 10,
                 collect_histograms: bool = False, histogram_bins: int = 20,
                 registry=None):
        self.router = router
        self.session_id = session_id or f"session_{int(time.time())}"
        self.worker_id = worker_id
        self.frequency = max(1, reporting_frequency)
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self._static_sent = False
        self._last_params_norms = None
        self._last_time = None
        self._last_iter = None
        self._pending_phase_timings = None
        # training telemetry also lands in the shared registry (default:
        # process-global), so serving and training share one scrape
        self.metrics = registry if registry is not None \
            else global_registry()
        self._m_score = self.metrics.gauge(
            "training_score", "loss at the last reporting iteration",
            labels=("worker",))
        self._m_iteration = self.metrics.gauge(
            "training_iteration", "last reported iteration",
            labels=("worker",))
        self._m_ips = self.metrics.gauge(
            "training_iterations_per_second", "training throughput",
            labels=("worker",))
        self._m_rss = self.metrics.gauge(
            "training_memory_rss_bytes", "host RSS at report time",
            labels=("worker",))
        self._m_report_ms = self.metrics.histogram(
            "training_report_interval_ms",
            "wall time between reporting iterations", labels=("worker",))

    # ------------------------------------------------------------------ hooks
    def on_epoch_start(self, model):
        if not self._static_sent:
            self._send_static(model)

    def on_phase_timings(self, model, timings: dict):
        """Buffer the round's phase wall times; they ride on the next
        update record (reference: SparkTrainingStats routed through the
        stats-storage pipeline). Nothing in the port calls it yet: its
        caller is the multi-process trainer (ROADMAP A11c)."""
        self._pending_phase_timings = timings

    def _send_static(self, model):
        """Session/model/hardware info (reference: initializeReporting +
        StaticInfo :~250)."""
        conf = model.conf
        backend, devices = _device_names(model)
        info = {
            "model_class": type(model).__name__,
            "num_params": int(model.num_params()) if model.params else 0,
            "num_layers": conf.n_layers() if hasattr(conf, "n_layers") else 0,
            "updater": type(conf.updater).__name__,
            "torch_backend": backend,
            "devices": devices,
            "config_json": conf.to_json(),
        }
        self.router.put_static_info(make_record(
            self.session_id, TYPE_ID, self.worker_id, info))
        self._static_sent = True

    def iteration_done(self, model, iteration: int):
        if not self._static_sent:
            self._send_static(model)
        if iteration % self.frequency != 0:
            return
        now = time.perf_counter()
        norms = _flat_norms(model.params)
        data = {
            "iteration": iteration,
            "epoch": getattr(model, "epoch", 0),
            "score": float(model.score_value),
            "param_norms": norms,
            "memory_rss_bytes": _rss_bytes(),
        }
        if self._last_params_norms is not None:
            # update magnitude proxy: |norm_t - norm_{t-1}| per param
            data["update_norms"] = {
                k: abs(norms[k] - self._last_params_norms[k])
                for k in norms if k in self._last_params_norms}
        if self._last_time is not None and iteration > self._last_iter:
            dt = now - self._last_time
            data["iterations_per_second"] = \
                (iteration - self._last_iter) / dt if dt > 0 else None
            data["duration_ms"] = dt * 1000.0
        if self._pending_phase_timings is not None:
            data["phase_timings"] = self._pending_phase_timings
            self._pending_phase_timings = None
        if self.collect_histograms:
            data["param_histograms"] = self._histograms(model.params)
        self.router.put_update(make_record(
            self.session_id, TYPE_ID, self.worker_id, data))
        self._m_score.labels(worker=self.worker_id).set(data["score"])
        self._m_iteration.labels(worker=self.worker_id).set(iteration)
        self._m_rss.labels(worker=self.worker_id).set(
            data["memory_rss_bytes"])
        if data.get("iterations_per_second"):
            self._m_ips.labels(worker=self.worker_id).set(
                data["iterations_per_second"])
        if "duration_ms" in data:
            self._m_report_ms.labels(worker=self.worker_id).observe(
                data["duration_ms"])
        self._last_params_norms = norms
        self._last_time = now
        self._last_iter = iteration

    def _histograms(self, params) -> dict:
        out = {}
        for k, v in _host_arrays(params).items():
            counts, edges = np.histogram(v, bins=self.histogram_bins)
            out[k] = {"counts": counts.tolist(), "min": float(edges[0]),
                      "max": float(edges[-1])}
        return out
