"""ParallelInference: a coalescing inference server on one card (the port of
``deeplearning4j_tpu/parallel/inference.py``).

Reference: parallelism/ParallelInference.java:33 — worker threads, an
observable queue, and request coalescing (BatchedInferenceObservable:
small requests are merged into one device batch, each caller gets its slice
back). The serving surface has two entries:

- ``output(x)`` — synchronous forward (one caller owns the batch).
- ``submit(x) -> Future`` — the BatchedInferenceObservable analogue: an
  async handle whose request is COALESCED with concurrent submissions by a
  background batcher (up to ``max_batch`` rows or a ``max_wait_ms``
  deadline, whichever first), dispatched as ONE padded-bucket forward, and
  sliced back per caller.

The device pipeline is the analogue of JAX's async dispatch: a coalescer
thread pads the batch to its bucket (the next power of two,
``optimize/bucketing.py``), launches the forward, records a CUDA event and
hands the un-fetched tensor to the completer thread through a bounded
queue (``inflight`` batches deep); the completer waits on the event and
copies the rows to the host, while the coalescer assembles and launches
the next batch. Both entries pad to the same buckets, so a row served
through a batch of B rows equals, bit for bit, the net's own
``output()`` over B rows. The eager forward compiles nothing per shape;
the ``BoundedCache`` keeps one forward per (bucket shape, mask) key, the
keys JAX's program cache holds.

PyTorch's grad mode is per thread: every forward here runs under its own
``torch.inference_mode()``, on whichever thread launches it.

The serving path is guarded end to end (parallel/resilience.py): every
``submit`` passes admission control (beyond ``max_pending`` in-flight
requests, reject with ``ServerOverloaded`` instead of queueing
unboundedly) and the circuit breaker's gate (``CircuitOpen`` fast-fail
while dispatches are failing at rate); a ``deadline_s`` budget travels
with the request and expires it in the coalescer BEFORE padding/dispatch
(``DeadlineExceeded`` — a forward is never wasted on a dead request);
dispatch runs under ``RetryPolicy`` backoff for ``TransientDispatchError``.
The invariant: an admitted request's future always resolves — with rows,
or with a typed error — never hangs.

Data-parallel inference (``mesh=``, ``workers``): the bucketed batch is
split into one equal piece per device of the mesh's ``data`` axis, each
device's replica of the params (``parallel/mesh.py::Replicas``) computes
its rows, and the rows are concatenated in order on the first device. The
coalescer, admission and resilience paths are the same whatever the
width.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.optimize.bucketing import (BoundedCache,
                                                     bucket_rows, pad_rows)
from deeplearning4j_torch.parallel.mesh import (MeshGeometryError,
                                                Replicas, all_gather,
                                                data_devices, data_mesh)
from deeplearning4j_torch.parallel.resilience import (AdmissionController,
                                                      ChaosPolicy,
                                                      CircuitBreaker,
                                                      CircuitOpen, Deadline,
                                                      DeadlineExceeded,
                                                      RetryPolicy)
from deeplearning4j_torch.parallel.runtime import (LoopClosed, LoopCrashed,
                                                   ServingLoop, supervisor)


class _Request:
    """One submitted observable: input rows + the future its slice lands in
    (the reference's InferenceObservable, minus the wait/notify), plus the
    request's deadline (None = unbounded) and its submit instant for the
    e2e latency histogram."""

    __slots__ = ("x", "mask", "n", "future", "deadline", "t0")

    def __init__(self, x, mask, deadline: Optional[Deadline] = None):
        self.x = x
        self.mask = mask
        self.n = x.shape[0]
        self.future: Future = Future()
        self.deadline = deadline
        self.t0 = time.monotonic()

    def signature(self):
        return (self.x.shape[1:], self.mask is not None)


def _host_rows(out: torch.Tensor) -> np.ndarray:
    """A forward's output as a host array (bf16 widened to f32: numpy has
    no bf16)."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


class ParallelInference:
    def __init__(self, net, mesh=None, workers: Optional[int] = None, *,
                 max_batch: int = 64, max_wait_ms: float = 3.0,
                 inflight: int = 2, max_pending: int = 256,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 chaos: Optional[ChaosPolicy] = None,
                 coalescers: int = 1, max_coalescers: int = 4,
                 registry: Optional[MetricsRegistry] = None,
                 quantize: Optional[str] = None, device=None):
        """``max_batch``/``max_wait_ms`` bound the coalescer: a batch is
        dispatched when it reaches ``max_batch`` rows or ``max_wait_ms``
        after its first request, whichever comes first. ``inflight`` bounds
        the dispatch pipeline (launched-but-unfetched batches).

        ``coalescers`` sets the initial batcher-thread count on the shared
        submit queue and ``max_coalescers`` bounds what
        ``set_coalescer_workers`` (the autoscaler's lever) may grow it to.

        Resilience knobs: ``max_pending`` is the admission high-watermark
        (requests beyond it are rejected with ``ServerOverloaded`` instead
        of queueing); ``retry`` retries ``TransientDispatchError`` with
        backoff (default ``RetryPolicy()``, pass a policy with
        ``max_attempts=1`` to disable); ``breaker`` fast-fails submits
        with ``CircuitOpen`` while dispatches fail at rate (default
        ``CircuitBreaker()``, pass ``breaker=False`` to disable); ``chaos``
        wraps the dispatch callable with a fault injector — test/bench
        only, default off.

        ``quantize="int8"`` serves absmax per-channel int8 weights
        (optimize/quantize.py) with the dequant fused into each matmul;
        the caller's net is untouched — the server quantizes a shallow
        copy. Default ``None`` serves the f32 params bit-exact.

        ``mesh`` (with a ``data`` axis) or ``workers`` (``data_mesh(
        workers)`` over the CUDA devices) sets the data-parallel width;
        with neither, the default is ``data_mesh()`` (every CUDA device)
        unless ``device`` names one device, which then serves alone. The
        server runs on the mesh's first device (a ``device`` naming
        another raises) and the net must live there."""
        if mesh is None:
            mesh = (data_mesh(devices=[resolve_device(device)])
                    if workers is None and device is not None
                    else data_mesh(workers))
        self.mesh = mesh
        self._devices = data_devices(mesh)
        self.device = self._devices[0]
        if device is not None and resolve_device(device) != self.device:
            raise MeshGeometryError(
                f"device={device} disagrees with the mesh, whose first "
                f"device {self.device} hosts the server")
        if net.device != self.device:
            raise ValueError(f"the net lives on {net.device}, the server on "
                             f"{self.device}; init the net on the server's "
                             "device")
        if quantize is not None:
            from deeplearning4j_torch.optimize.quantize import quantize_net
            net = quantize_net(net, quantize)
        self.quantize = quantize
        self.net = net
        self.workers = len(self._devices)
        self._replicas = Replicas(net)
        self._fwd_cache = BoundedCache()
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.inflight = max(1, int(inflight))
        self.max_coalescers = max(1, int(max_coalescers))
        self.admission = AdmissionController(max_pending)
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = (None if breaker is False
                        else breaker if breaker is not None
                        else CircuitBreaker())
        self._dispatch = (chaos.wrap(self._dispatch_fwd) if chaos is not None
                          else self._dispatch_fwd)
        # serving counters live in the registry (leaf-locked), so stats()
        # and the /metrics scrape never take a serving lock
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._m_dispatches = self.metrics.counter(
            "inference_dispatches_total", "device program calls issued")
        self._m_rejected_circuit = self.metrics.counter(
            "inference_rejected_circuit_total",
            "submits fast-failed by the open breaker")
        self._m_retried = self.metrics.counter(
            "inference_retried_total", "dispatch retry attempts")
        self._m_expired = self.metrics.counter(
            "inference_expired_total", "requests expired before dispatch")
        self._m_completed = self.metrics.counter(
            "inference_completed_total", "futures resolved with rows")
        self._m_failed = self.metrics.counter(
            "inference_failed_total", "futures resolved with a typed error")
        self._m_latency = self.metrics.histogram(
            "inference_latency_ms", "submit-to-resolution latency")
        self._m_batch_rows = self.metrics.histogram(
            "inference_batch_rows", "rows per coalesced dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self.metrics.gauge("inference_pending", "requests in flight",
                           fn=lambda: self.admission.pending)
        self.metrics.gauge("inference_accepted", "admission accepts",
                           fn=lambda: self.admission.accepted)
        self.metrics.gauge("inference_rejected", "admission rejects",
                           fn=lambda: self.admission.rejected)
        self.metrics.gauge("inference_breaker_open",
                           "0 closed / 0.5 half-open / 1 open",
                           fn=self._breaker_level)
        self.metrics.gauge("inference_coalescer_workers",
                           "live coalescer threads",
                           fn=lambda: self.coalescer_workers)
        self._drain_cv = threading.Condition()
        self._draining = False
        self._chaos = chaos
        # both worker stacks are hosted on the shared serving runtime
        # (parallel/runtime.py): the coalescer pool and the completer are
        # each one supervised ServingLoop with the uniform
        # NEW/RUNNING/DRAINING/CLOSED lifecycle
        self._coalescer: Optional[ServingLoop] = None
        self._completer: Optional[ServingLoop] = None
        # futures admitted but not yet resolved: the supervisor's
        # on_death contract fails every one of these typed when a loop
        # thread dies, so a crash mid-batch cannot strand a caller
        self._outstanding: set = set()
        self._lock = threading.Lock()
        self._closed = False
        self._coalescer_target = min(self.max_coalescers,
                                     max(1, int(coalescers)))

    def _breaker_level(self) -> float:
        if self.breaker is None:
            return 0.0
        return {"closed": 0.0, "half_open": 0.5,
                "open": 1.0}.get(self.breaker.state, 0.0)

    @property
    def dispatch_count(self) -> int:
        """Forwards issued (coalescing efficiency metric: N submits
        completing in 1 dispatch is the point of the batcher)."""
        return int(self._m_dispatches.value)

    # ------------------------------------------------------- bucket forwards
    def _get_fwd(self, shape, has_mask):
        """The forward of one (bucket shape, mask) key: the MultiLayerNetwork
        or single-input/single-output ComputationGraph forward at the net's
        current parameters, in inference mode; over W devices, each
        device's replica forwards its 1/W of the rows and the rows are
        concatenated in order on the first device."""
        key = (shape, has_mask)
        if key not in self._fwd_cache:
            net = self.net
            if hasattr(net, "layers") and isinstance(net.layers, list):
                def one(params, state, x, mask):
                    out, _, _ = net._forward(params, state, x, mask,
                                             train=False)
                    return out
            else:  # ComputationGraph, single input/output
                def one(params, state, x, mask):
                    outs, _, _, _ = net._forward(params, state, [x],
                                                 [mask], train=False)
                    return outs[0]
            devices = self._devices

            def fwd(x, mask):
                rows = x.shape[0] // len(devices)
                outs = []
                for i, dev in enumerate(devices):
                    part = slice(i * rows, (i + 1) * rows)
                    outs.append(one(
                        *self._replicas.weights(dev), x[part].to(dev),
                        None if mask is None else mask[part].to(dev)))
                return outs[0] if len(outs) == 1 else all_gather(
                    outs, self.device)

            self._fwd_cache[key] = fwd
        return self._fwd_cache[key]

    def _dispatch_fwd(self, x, mask):
        """Pad to the bucket and launch the forward; returns the un-fetched
        output and the CUDA event recorded behind it (None on the CPU). The
        caller strips the padding."""
        n = x.shape[0]
        B = bucket_rows(n, multiple=self.workers)
        xt = self.net._as_tensor(x, getattr(torch, self.net.conf.dtype))
        mt = None if mask is None else self.net._as_tensor(mask,
                                                           torch.float32)
        if B != n:
            xt = pad_rows(xt, B)
            if mt is not None:
                mt = pad_rows(mt, B)
        fwd = self._get_fwd(tuple(xt.shape), mt is not None)
        with torch.inference_mode():
            out = fwd(xt, mt)
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._m_dispatches.inc()
        return out, event

    @staticmethod
    def _fetch(pending) -> np.ndarray:
        """Wait for a launched forward and copy its rows to the host."""
        out, event = pending
        if event is not None:
            event.synchronize()
        return _host_rows(out)

    # ---------------------------------------------------------- sync entry
    def output(self, x, mask=None) -> np.ndarray:
        """Forward on the card; the batch is padded to the bucket size
        (a power of two) and the padding stripped from the result."""
        x = np.asarray(x)
        return self._fetch(self._dispatch_fwd(x, mask))[:x.shape[0]]

    # --------------------------------------------------------- async entry
    def submit(self, x, mask=None, *,
               deadline_s: Optional[float] = None) -> Future:
        """Async inference: returns a Future of this request's output rows.
        Requests submitted concurrently are coalesced into one device batch
        (the reference's BatchedInferenceObservable); each future resolves
        to exactly its own rows, in row order.

        ``deadline_s`` is the request's time budget from this call: a
        request still undispatched when it expires fails with
        ``DeadlineExceeded`` (checked in the coalescer BEFORE padding and
        dispatch, so no forward is spent on it). Raises
        ``ServerOverloaded`` when ``max_pending`` requests are in flight
        and ``CircuitOpen`` while the breaker is open — both immediately,
        never by blocking the caller."""
        with self._lock:
            if self._closed or self._draining:
                raise RuntimeError("ParallelInference is closed"
                                   if self._closed else
                                   "ParallelInference is draining")
            co = self._ensure_workers()
        if self.breaker is not None and not self.breaker.allow():
            self._m_rejected_circuit.inc()
            raise CircuitOpen("circuit breaker is open: recent dispatches "
                              "failed above threshold")
        self.admission.acquire()  # raises ServerOverloaded at watermark
        x = np.asarray(x)
        if x.ndim < 2:
            x = x[None]  # single example -> 1-row batch
        req = _Request(x, None if mask is None else np.asarray(mask),
                       None if deadline_s is None else Deadline(deadline_s))
        # the done-callback is the single release point for admission and
        # the completion counters: it fires on EVERY resolution path
        # (result, typed failure, shutdown drain), so pending can never
        # leak no matter which thread resolves the future
        req.future.add_done_callback(
            lambda f, t0=req.t0: self._on_done(f, t0))
        with self._lock:
            self._outstanding.add(req.future)
        try:
            co.put(req)
        except LoopClosed:
            # close() (or a loop crash) raced this submit past the checks
            # above: fail the future rather than hang the caller. _fail
            # tolerates the other side of the race having resolved it.
            with self._lock:
                closed = self._closed
            self._fail(req.future,
                       RuntimeError("ParallelInference is closed") if closed
                       else LoopCrashed("pi-coalescer is restarting; "
                                        "resubmit the request"))
            return req.future
        with self._lock:
            closed = self._closed
        if closed and not req.future.done():
            # the put itself raced close() in: the runtime's leftover
            # drain (re-run by put()) normally fails it, but cover the
            # window where the drain ran before our enqueue landed
            self._fail(req.future,
                       RuntimeError("ParallelInference is closed"))
        return req.future

    def _on_done(self, fut: Future, t0: Optional[float] = None) -> None:
        with self._lock:
            self._outstanding.discard(fut)
        self.admission.release()
        if fut.exception() is None:
            self._m_completed.inc()
            if t0 is not None:
                self._m_latency.observe((time.monotonic() - t0) * 1e3)
        else:
            self._m_failed.inc()
        with self._drain_cv:
            self._drain_cv.notify_all()

    def stats(self) -> dict:
        """Serving counters (monotone except pending/breaker_state), the
        JAX server's keys in its order. The snapshot is assembled entirely
        OUTSIDE the serving locks — every counter is a leaf-locked
        registry metric."""
        out = {"retried": int(self._m_retried.value),
               "expired": int(self._m_expired.value),
               "rejected_circuit": int(self._m_rejected_circuit.value),
               "completed": int(self._m_completed.value),
               "failed": int(self._m_failed.value),
               "dispatches": int(self._m_dispatches.value)}
        out.update(
            accepted=self.admission.accepted,
            rejected=self.admission.rejected,
            pending=self.admission.pending,
            breaker_state=(self.breaker.state if self.breaker is not None
                           else "disabled"))
        return out

    @staticmethod
    def _fail(future: Future, exc: Exception) -> None:
        """set_exception tolerating an already-resolved future (the
        completer and a closing drain can race on shutdown)."""
        try:
            future.set_exception(exc)
        except Exception:  # noqa: BLE001 — already resolved, either way
            pass

    def _ensure_workers(self) -> ServingLoop:
        """Start the runtime loops once and return the coalescer loop.
        Caller must hold ``self._lock``. Both loop refs are published to
        the instance BEFORE any request can reach a worker (the first
        put happens after this returns), so ``_coalesce_entry`` can
        snapshot them safely."""
        if self._coalescer is None:
            # bounded completer inbox: backpressures the coalescers when
            # `inflight` batches are launched but not yet fetched
            completer = ServingLoop(
                "pi-completer", handler=self._complete_loop,
                inbox_maxsize=self.inflight,
                on_leftover=self._fail_inflight_leftover,
                chaos=self._chaos)
            coalescer = ServingLoop(
                "pi-coalescer", handler=self._coalesce_entry,
                workers=self._coalescer_target,
                max_workers=self.max_coalescers,
                on_leftover=self._fail_submit_leftover,
                chaos=self._chaos)
            self._completer = completer
            self._coalescer = coalescer
            completer.start()
            coalescer.start()
            sup = supervisor()
            sup.watch(completer, on_death=self._on_loop_death, restart=True)
            sup.watch(coalescer, on_death=self._on_loop_death, restart=True)
        return self._coalescer

    def _on_loop_death(self, loop: ServingLoop, exc: BaseException):
        """Uniform recovery contract (LoopSupervisor): every admitted but
        unresolved future fails typed — a dead loop thread never strands
        a caller — and the supervised restart proceeds unless the server
        is deliberately closing."""
        with self._lock:
            victims = list(self._outstanding)
            closed = self._closed
        err = LoopCrashed(f"{loop.name} died with the request in flight: "
                          f"{exc!r}")
        for f in victims:
            if not f.done():
                self._fail(f, err)
        return not closed

    def _fail_submit_leftover(self, req) -> None:
        self._fail(req.future, RuntimeError("ParallelInference is closed"))

    def _fail_inflight_leftover(self, item) -> None:
        _pending, batch = item
        for r in batch:
            self._fail(r.future, RuntimeError("ParallelInference is closed"))

    @property
    def coalescer_workers(self) -> int:
        """Desired coalescer-thread count (the autoscaler's observable)."""
        with self._lock:
            return self._coalescer_target

    def set_coalescer_workers(self, n: int) -> int:
        """Scale the coalescer pool to ``n`` threads (clamped to
        [1, max_coalescers]). Scale-up spawns threads on the shared
        inbox; scale-down retires workers via the runtime's resign
        tokens, so a coalescer finishes its current batch and exits
        cleanly. The target never drops below 1, so the shutdown
        sentinel always finds a live coalescer to propagate through."""
        n = min(self.max_coalescers, max(1, int(n)))
        with self._lock:
            if self._closed:
                return self._coalescer_target
            self._coalescer_target = n
            co = self._coalescer
        if co is not None:
            co.set_workers(n)
        return n

    def _expire_if_dead(self, req) -> bool:
        """Fail an already-expired request with DeadlineExceeded (True),
        or report it still live (False). Every coalescer touchpoint runs
        this BEFORE spending work on the request."""
        if req.deadline is None or not req.deadline.expired():
            return False
        self._m_expired.inc()
        self._fail(req.future, DeadlineExceeded(
            f"request expired {-req.deadline.remaining() * 1e3:.1f} ms "
            "before dispatch"))
        return True

    @staticmethod
    def _flush_by(d) -> float:
        """Latest instant the assembly window may run to for a member with
        deadline ``d``: a quarter of the member's remaining budget is
        reserved for the dispatch itself, so flushing at the window edge
        still lands BEFORE expiry instead of exactly on it."""
        return d.expires_at - 0.25 * max(0.0, d.remaining())

    def _coalesce_entry(self, first):
        """Coalescer loop handler. Snapshots the loop refs under the
        lock, then assembles and dispatches entirely outside it — the
        retry backoff and queue waits in the batch path must never run
        under ``self._lock``."""
        with self._lock:
            co, completer = self._coalescer, self._completer
        return self._coalesce_once(first, co, completer)

    def _coalesce_once(self, first, co: ServingLoop, completer: ServingLoop):
        """Coalescer handler: assemble ONE batch starting from ``first``
        and dispatch it. Returns the mismatched request that forced an
        early flush (the runtime hands it back as this worker's next
        head), or None. Sentinel/resign/pool-walk choreography lives in
        the runtime, not here."""
        if self._expire_if_dead(first):
            return None
        head = None
        batch = [first]
        rows = first.n
        sig = first.signature()
        deadline = time.monotonic() + self.max_wait_s
        if first.deadline is not None:
            # remaining-time propagation: a member with less budget
            # than the coalesce window flushes the batch early, so it
            # is dispatched before it expires rather than after
            deadline = min(deadline, self._flush_by(first.deadline))
        while rows < self.max_batch:
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            try:
                # loop.get never hands out control tokens: a shutdown
                # sentinel arriving mid-assembly re-queues and raises
                # Empty, so the batch flushes and the main consume loop
                # runs the pool walk
                nxt = co.get(timeout=wait)
            except queue.Empty:
                break
            if nxt.signature() != sig:
                head = nxt  # flush now; the mismatch starts its own batch
                break
            if self._expire_if_dead(nxt):
                continue
            batch.append(nxt)
            rows += nxt.n
            if nxt.deadline is not None:
                deadline = min(deadline, self._flush_by(nxt.deadline))
        self._dispatch_batch(batch, completer)
        return head

    def _count_retry(self, attempt, exc) -> None:
        self._m_retried.inc()

    def _dispatch_batch(self, batch, completer: ServingLoop):
        # last expiry gate: members that died waiting in the assembly
        # window fail typed here, before any padding or device work
        batch = [r for r in batch if not self._expire_if_dead(r)]
        if not batch:
            return
        self._m_batch_rows.observe(sum(r.n for r in batch))
        earliest = min((r.deadline for r in batch if r.deadline is not None),
                       key=lambda d: d.expires_at, default=None)

        def attempt():
            try:
                out = self._dispatch(x, mask)  # launched, not fetched
            except Exception:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            return out

        try:
            x = (batch[0].x if len(batch) == 1
                 else np.concatenate([r.x for r in batch]))
            mask = None
            if batch[0].mask is not None:
                mask = (batch[0].mask if len(batch) == 1
                        else np.concatenate([r.mask for r in batch]))
            pending = self.retry.call(attempt, deadline=earliest,
                                      on_retry=self._count_retry)
        except Exception as e:  # noqa: BLE001 — surface on every future
            for r in batch:
                # a member whose budget died during the retry storm fails
                # as DeadlineExceeded; the rest carry the original error
                if not self._expire_if_dead(r):
                    self._fail(r.future, e)
            return
        # bounded pipeline: blocks when `inflight` batches are already
        # pending, so device compute overlaps the NEXT batch's host
        # assembly. The put is chunked so a dead completer cannot wedge
        # this coalescer forever: each timeout re-checks the completer's
        # health and fails the batch typed instead of stranding it.
        while True:
            if completer.crashed is not None:
                err = LoopCrashed("pi-completer died with the batch in "
                                  "flight")
                for r in batch:
                    self._fail(r.future, err)
                return
            try:
                completer.put((pending, batch), timeout=0.2)
                return
            except queue.Full:
                continue
            except LoopClosed:
                err = RuntimeError("ParallelInference is closed")
                for r in batch:
                    self._fail(r.future, err)
                return

    def _complete_loop(self, item):
        """Completer handler: THE single device fetch per coalesced
        batch, sliced back per caller. Hosted on its own ServingLoop so
        the fetch overlaps the coalescers' next assembly."""
        pending, batch = item
        try:
            arr = self._fetch(pending)  # the device fetch for this batch
        except Exception as e:  # noqa: BLE001
            for r in batch:
                self._fail(r.future, e)
            return None
        ofs = 0
        for r in batch:
            try:
                r.future.set_result(arr[ofs:ofs + r.n])
            except Exception:  # noqa: BLE001 — lost a shutdown race
                pass
            ofs += r.n
        return None

    # ------------------------------------------------------------ lifecycle
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admitting new submits (they raise
        RuntimeError) while every in-flight request runs to resolution.
        Returns True once nothing is pending, False if ``timeout`` seconds
        pass first (in-flight work keeps completing either way). The first
        phase of ``close()``; also usable alone for zero-loss handoff
        (drain, swap weights/process, resume)."""
        with self._lock:
            self._draining = True
            co, cm = self._coalescer, self._completer
        # advance the runtime state machines too, so shutdown-phase chaos
        # (kill_during_drain) fires on work handled from here on
        if co is not None:
            co.begin_drain()
        if cm is not None:
            cm.begin_drain()
        limit = None if timeout is None else time.monotonic() + timeout
        while True:
            # liveness read OUTSIDE _drain_cv: ServingLoop._cond is never
            # acquired while the drain condition is held
            dead = co is None or (co.alive_workers == 0
                                  and (cm is None
                                       or cm.alive_workers == 0))
            with self._drain_cv:
                if self.admission.pending == 0:
                    return True
                if dead:
                    # no loop worker will ever resolve the remainder
                    # (crashed loops, or staged shutdown tests): close()'s
                    # leftover drain owns those requests
                    return False
                wait = 0.2 if limit is None else min(
                    0.2, limit - time.monotonic())
                if wait <= 0:
                    return False
                self._drain_cv.wait(wait)  # chunked: re-checks liveness

    def close(self, timeout: float = 30.0):
        """Drain (complete in-flight work, reject new submissions), then
        flush and stop both runtime loops. Idempotent and re-entrant
        (any thread, twice, concurrently): the runtime's sole-closer
        discipline makes late callers wait on the first closer's
        completion event. Pending futures complete before the loops
        exit; requests that raced the shutdown in behind the sentinel
        are FAILED with RuntimeError, never left unresolved."""
        with self._lock:
            should_drain = not self._closed and self._coalescer is not None
        if should_drain:
            self.drain(timeout)
        with self._lock:
            self._closed = True
            co, cm = self._coalescer, self._completer
        if co is None:
            return
        co.close(timeout)
        cm.close(timeout)
        # a submit that raced close() past the runtime's own leftover
        # drain may have re-queued behind the sentinel: run the
        # idempotent drain once more
        co.fail_leftovers()
        # a stalled/killed worker can leave popped-but-unresolved
        # requests behind (stall_sentinel chaos): fail whatever is still
        # outstanding so no caller ever hangs on result()
        with self._lock:
            victims = [f for f in self._outstanding if not f.done()]
        for f in victims:
            self._fail(f, RuntimeError("ParallelInference is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
