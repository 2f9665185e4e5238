"""Keras-backend entry point: drive training and serving of models from an
external process (the port of ``deeplearning4j_tpu/modelimport/server.py``).

Reference: deeplearning4j-keras — a py4j ``GatewayServer``
(keras/Server.java:18) exposing ``DeepLearning4jEntryPoint.fit``
(keras/DeepLearning4jEntryPoint.java:12,21-33): a Python Keras process
hands over an exported model file plus minibatch files on disk, and the
JVM trains. Here the transport is stdlib HTTP+JSON (py4j is a JVM bridge;
an HTTP entry point serves any client), batches are ``.npz`` files with
``features``/``labels`` arrays (the HDF5MiniBatchDataSetIterator analog):

- POST /import   {"path": "model.h5"}                   -> {"model": id}
                  (not ported yet: a structured 500 naming ROADMAP A12)
- POST /fit      {"model": id, "batches": [paths], "epochs": n}
- POST /evaluate {"model": id, "batches": [paths]}      -> {"accuracy": ..}
- POST /predict  {"model": id, "features": [[..], ..],
                  "deadline_s": 2.0}                    -> {"output": ..}
- POST /generate {"model": id, "prompt_ids": [..], "max_tokens": n,
                  "temperature": t, "top_k": k, "seed": s,
                  "deadline_s": 2.0}                    -> {"tokens": [..]}
- POST /rag      {"model": id, "prompt_ids": [..], "max_tokens": n,
                  "query_vec": [..], "k": 4, ...}
                  -> {"tokens": [..], "docs": [..], "prefix_len": n}
                  (not ported yet: a structured 500 naming ROADMAP A9)
- GET  /models                                          -> {"models": [..]}
- GET  /stats                                           -> serving counters
- GET  /metrics                     -> Prometheus text exposition (0.0.4)

/generate serves models registered with ``attach_generation`` through a
slot-pooled continuous-batching ``GenerationServer``
(parallel/generation.py) and maps its typed failures onto the same
taxonomy: 429 past the admission watermark, 503 while the breaker is
open, 504 when the per-request deadline expires (queued OR
mid-generation — the decode slot is freed either way).

Models are registered with ``attach_generation`` / ``attach_inference``
(or placed in ``_models`` directly); their servers run on the card unless
the caller passes ``device="cpu"``. ``/rag`` (``attach_rag``, the two-tier
``RagPipeline``) waits for ROADMAP A9 and ``/import`` (Keras HDF5 import)
for A12: both raise ``NotImplementedError`` naming their item, which the
handler returns as the structured 500 JSON.

The serving path degrades typed instead of failing open
(parallel/resilience.py): /predict sheds load with 429 past the
``max_pending`` admission watermark, fast-fails 503 while the circuit
breaker is open, 504s requests whose ``deadline_s`` budget ran out, and
retries transient dispatch faults with backoff. Malformed JSON, unknown
model ids, and bodies beyond ``max_body_bytes`` return structured 4xx
JSON errors ({"error": ..., "type": ...}) — never a traceback-driven 500
or unbounded buffering.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.metrics.exposition import CONTENT_TYPE, render_text
from deeplearning4j_torch.metrics.registry import (MetricsRegistry,
                                                   global_registry)
from deeplearning4j_torch.parallel.resilience import (AdmissionController,
                                                      ChaosPolicy,
                                                      CircuitBreaker,
                                                      CircuitOpen, Deadline,
                                                      DeadlineExceeded,
                                                      ReplicaKilled,
                                                      ReplicaUnavailable,
                                                      RetryPolicy,
                                                      ServerOverloaded,
                                                      TransientDispatchError)


class UnknownModelError(KeyError):
    """Request named a model id this server never imported (HTTP 404 —
    distinct from a bare KeyError, which means a missing request field
    and maps to 400)."""


#: error type -> HTTP status for the typed serving taxonomy
_STATUS = {
    ServerOverloaded: 429,
    CircuitOpen: 503,          # incl. every fleet replica breaker open
    TransientDispatchError: 503,  # retry budget spent on transient faults
    ReplicaUnavailable: 503,   # whole fleet dead/draining/restarting
    ReplicaKilled: 503,        # replica died and the failover budget ended
    DeadlineExceeded: 504,
}


def _host(out) -> np.ndarray:
    """A model output as a host array (a tensor is fetched from its device;
    bf16 widens to f32, which numpy can hold)."""
    if torch.is_tensor(out):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.float()
        out = out.cpu().numpy()
    return np.asarray(out)


class KerasBackendServer:
    def __init__(self, port: int = 0, *, max_body_bytes: int = 64 << 20,
                 max_pending: int = 64,
                 request_deadline_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 chaos: Optional[ChaosPolicy] = None,
                 registry: Optional[MetricsRegistry] = None):
        """Resilience knobs mirror ``ParallelInference``: ``max_pending``
        bounds concurrent in-flight requests (beyond it /predict returns
        429 immediately), ``request_deadline_s`` is the default /predict
        budget (per-request ``deadline_s`` in the JSON body overrides; None
        = unbounded), ``retry``/``breaker`` guard the model dispatch, and
        ``chaos`` injects faults into it — test/bench only, default off.
        ``max_body_bytes`` caps request bodies (413 beyond it; the body
        is discarded unbuffered, never parsed)."""
        self._port = port
        self._models: dict = {}
        self._generators: dict = {}
        self._inference: dict = {}
        # leaf lock for the /predict server registry: predict() must not
        # touch self._lock before admission (the legacy path holds it for
        # the whole dispatch — the watermark could never 429)
        self._inference_lock = threading.Lock()
        self._next_id = 0
        self._lock = threading.Lock()
        self._httpd = None
        self._thread = None
        self.max_body_bytes = int(max_body_bytes)
        self.request_deadline_s = request_deadline_s
        self.admission = AdmissionController(max_pending)
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._chaos = chaos
        # serving counters live in the (leaf-locked) registry; GET
        # /metrics renders this registry merged with every attached
        # model's own (labeled by model id) plus any register_metrics()
        # extras and the process-global training registry
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._m_retried = self.metrics.counter(
            "server_retried_total", "dispatch retries")
        self._m_expired = self.metrics.counter(
            "server_expired_total", "requests failed on deadline")
        self._m_rejected_circuit = self.metrics.counter(
            "server_rejected_circuit_total",
            "requests shed while the breaker was open")
        self._m_completed = self.metrics.counter(
            "server_completed_total", "requests completed")
        self._m_failed = self.metrics.counter(
            "server_failed_total", "requests failed on error")
        self.metrics.gauge("server_pending",
                           "admitted-but-unresolved requests",
                           fn=lambda: self.admission.pending)
        self.metrics.gauge("server_accepted",
                           "requests accepted by admission",
                           fn=lambda: self.admission.accepted)
        self.metrics.gauge("server_rejected",
                           "requests rejected by admission",
                           fn=lambda: self.admission.rejected)
        self.metrics.gauge("server_models", "imported models",
                           fn=lambda: len(self._models))
        self._extra_metrics: list = []

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    # ---------------------------------------------------------- operations
    def import_model(self, path: str) -> str:
        """Keras HDF5 import: not ported yet."""
        raise NotImplementedError(
            "import_model (/import) is not ported yet (ROADMAP A12: Keras "
            "HDF5 model import)")

    def _net(self, mid: str):
        net = self._models.get(mid)
        if net is None:
            raise UnknownModelError(f"unknown model '{mid}'")
        return net

    @staticmethod
    def _load_batches(paths):
        from deeplearning4j_torch.datasets.dataset import DataSet

        out = []
        for p in paths:
            with np.load(p) as z:
                out.append(DataSet(z["features"], z["labels"]))
        return out

    def fit(self, mid: str, batch_paths, epochs: int = 1) -> dict:
        # one lock serializes all model operations: ThreadingHTTPServer
        # handles requests concurrently, and two interleaved fit() calls on
        # one net would race on its iteration/score/updater state
        with self._lock:
            net = self._net(mid)
            batches = self._load_batches(batch_paths)
            for _ in range(epochs):
                for ds in batches:
                    net.fit(ds)
            return {"iterations": int(net.iteration),
                    "score": float(net.score_value)}

    def evaluate(self, mid: str, batch_paths) -> dict:
        from deeplearning4j_torch.evaluation.classification import Evaluation

        with self._lock:
            net = self._net(mid)
            ev = Evaluation()
            for ds in self._load_batches(batch_paths):
                ev.eval(ds.labels, _host(net.output(ds.features)))
            return {"accuracy": ev.accuracy(), "f1": ev.f1()}

    def _count_retry(self, attempt, exc) -> None:
        self._m_retried.inc()

    def _check_deadline(self, deadline: Optional[Deadline], stage: str):
        if deadline is not None and deadline.expired():
            self._m_expired.inc()
            raise DeadlineExceeded(
                f"request budget exhausted {stage} "
                f"({-deadline.remaining() * 1e3:.1f} ms over)")

    def predict(self, mid: str, features,
                deadline_s: Optional[float] = None) -> list:
        """The guarded serving entry: admission -> breaker gate -> model
        lock -> dispatch under retry, with the deadline re-checked at each
        stage boundary so a request whose budget died waiting never costs
        a device program. Models registered with ``attach_inference``
        route through their coalescing server (or replica fleet) instead —
        its own admission/breaker/deadline typing maps onto the same
        429/503/504 taxonomy."""
        budget = deadline_s if deadline_s is not None \
            else self.request_deadline_s
        with self._inference_lock:
            inf = self._inference.get(mid)
        if inf is not None:
            x = np.asarray(features, np.float32)
            fut = inf.submit(x, deadline_s=budget)
            try:
                # the server resolves deadlined requests itself; the slack
                # only guards a wedged server from hanging the HTTP thread
                out = fut.result(timeout=None if budget is None
                                 else budget + 30.0)
            except Exception:
                self._m_failed.inc()
                raise
            self._m_completed.inc()
            return _host(out).tolist()
        deadline = None if budget is None else Deadline(budget)
        if not self.breaker.allow():
            self._m_rejected_circuit.inc()
            raise CircuitOpen("circuit breaker is open: recent dispatches "
                              "failed above threshold")
        self.admission.acquire()  # raises ServerOverloaded at watermark
        try:
            with self._lock:
                # the model-lock wait can eat the whole budget under load
                self._check_deadline(deadline, "waiting for the model lock")
                net = self._net(mid)
            x = np.asarray(features, np.float32)
            dispatch = (self._chaos.wrap(net.output)
                        if self._chaos is not None else net.output)

            def attempt():
                # each ATTEMPT serializes under the model lock, but the
                # retry backoff sleeps happen outside it: one request's
                # retry storm must not stall every other HTTP worker
                with self._lock:
                    self._check_deadline(deadline,
                                         "waiting for the model lock")
                    try:
                        result = dispatch(x)
                    except Exception:
                        self.breaker.record_failure()
                        raise
                    self.breaker.record_success()
                    return result

            out = self.retry.call(attempt, deadline=deadline,
                                  on_retry=self._count_retry)
            self._m_completed.inc()
        except Exception:
            self._m_failed.inc()
            raise
        finally:
            self.admission.release()
        if isinstance(out, (list, tuple)):
            out = out[0]
        return _host(out).tolist()

    def attach_generation(self, net, *, vocab: int, slots: int = 4,
                          eos_id: Optional[int] = None,
                          mid: Optional[str] = None, replicas: int = 1,
                          fleet_kw: Optional[dict] = None,
                          roles: Optional[Sequence[str]] = None,
                          device=None, **gen_kw) -> str:
        """Register a causal LM for /generate, served by a paged
        ``GenerationServer`` (continuous batching over a page-pool
        KV-cache — parallel/generation.py). ``net`` may be a model
        instance or an already-imported model id; returns the model id
        /generate requests should name. Extra kwargs are forwarded to
        the ``GenerationServer``: paging (``page_size``, ``pages``,
        ``prefix_cache``, ``prefill_chunk``, ``steps_per_dispatch``),
        speculative decoding (``draft_net``, ``spec_k``), and
        resilience (max_pending, request_deadline_s, retry, breaker,
        chaos, ...). Page-pool occupancy, prefix-cache reuse, COW, and
        speculation counters surface per model under ``pages`` in
        /stats.

        ``replicas > 1`` serves the model through a ``ReplicaFleet`` of
        independent GenerationServers (health-routed failover, supervised
        restart, zero lost futures across replica death — parallel/
        fleet.py); ``fleet_kw`` forwards to the fleet (hedge_after_s,
        restart_backoff_s, ...). The per-replica health/breaker/restart
        block then appears under this model in /stats.

        ``roles`` (rid-indexed, e.g. ``("prefill", "decode")``) serves
        the model through *disaggregated* tiers: each replica's
        GenerationServer is built with its declared role and the fleet
        routes fresh requests through prefill-export -> decode-adopt,
        degrading to co-located serving when the decode tier is dark.
        Requires ``replicas == len(roles) > 1``.

        ``device``: the card every server runs on (CUDA unless the caller
        passes another device; the net must live there)."""
        from deeplearning4j_torch.parallel.fleet import ReplicaFleet
        from deeplearning4j_torch.parallel.generation import GenerationServer

        device = resolve_device(device)
        with self._lock:
            if isinstance(net, str):
                mid = net
                net = self._net(mid)
            elif mid is None:
                mid = f"m{self._next_id}"
                self._next_id += 1
            self._models[mid] = net
            old = self._generators.pop(mid, None)
        if old is not None:
            old.close()
        if roles is not None and int(replicas) <= 1:
            raise ValueError("roles= needs replicas > 1 (one server "
                             "per tier replica)")
        if int(replicas) > 1:
            def factory(rid):
                kw = dict(gen_kw)
                if roles is not None:
                    kw["role"] = roles[rid]
                return GenerationServer(net, vocab, slots=slots,
                                        eos_id=eos_id, device=device, **kw)
            fkw = dict(fleet_kw or {})
            if roles is not None:
                fkw.setdefault("roles", tuple(roles))
            gen = ReplicaFleet(factory, replicas=int(replicas), **fkw)
        else:
            gen = GenerationServer(net, vocab, slots=slots, eos_id=eos_id,
                                   device=device, **gen_kw)
        with self._lock:
            self._generators[mid] = gen
        return mid

    def attach_inference(self, net, *, mid: Optional[str] = None,
                         replicas: int = 1,
                         fleet_kw: Optional[dict] = None,
                         device=None, **inf_kw) -> str:
        """Register a model for /predict behind a coalescing
        ``ParallelInference`` server — or, with ``replicas > 1``, a
        ``ReplicaFleet`` of them — instead of the default
        lock-serialized direct dispatch. ``net`` may be a model instance
        or an imported model id; ``inf_kw`` forwards to each
        ``ParallelInference`` (max_batch, max_wait_ms, max_pending,
        chaos, ...), ``fleet_kw`` to the fleet; ``device`` is the card every
        server runs on (CUDA unless the caller passes another device)."""
        from deeplearning4j_torch.parallel.fleet import ReplicaFleet
        from deeplearning4j_torch.parallel.inference import ParallelInference

        device = resolve_device(device)
        with self._lock:
            if isinstance(net, str):
                mid = net
                net = self._net(mid)
            elif mid is None:
                mid = f"m{self._next_id}"
                self._next_id += 1
            self._models[mid] = net
        with self._inference_lock:
            old = self._inference.pop(mid, None)
        if old is not None:
            old.close()
        if int(replicas) > 1:
            def factory(rid):
                return ParallelInference(net, device=device, **inf_kw)
            inf = ReplicaFleet(factory, replicas=int(replicas),
                               **(fleet_kw or {}))
        else:
            inf = ParallelInference(net, device=device, **inf_kw)
        with self._inference_lock:
            self._inference[mid] = inf
        return mid

    def attach_rag(self, net, *, vocab: int, passages, doc_vectors,
                   k: int = 4, slots: int = 4, page_size: int = 16,
                   pad_id: int = 0, knn_replicas: int = 1,
                   generate_replicas: int = 1, mid: Optional[str] = None,
                   encoder=None, index_kw: Optional[dict] = None,
                   gen_kw: Optional[dict] = None,
                   rag_kw: Optional[dict] = None) -> str:
        """Retrieval-augmented serving (the two-tier ``RagPipeline``): not
        ported yet."""
        raise NotImplementedError(
            "attach_rag is not ported yet (ROADMAP A9: parallel/rag.py with "
            "the retrieval tier)")

    def rag(self, mid: str, prompt_ids, max_tokens: int,
            query_vec=None, k: Optional[int] = None,
            temperature: float = 0.0, top_k: int = 0, seed: int = 0,
            deadline_s: Optional[float] = None) -> dict:
        """/rag: not ported yet (see ``attach_rag``)."""
        raise NotImplementedError(
            "/rag is not ported yet (ROADMAP A9: parallel/rag.py with the "
            "retrieval tier)")

    def generate(self, mid: str, prompt_ids, max_tokens: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 deadline_s: Optional[float] = None) -> list:
        """Submit one generation request and wait for its tokens. The
        GenerationServer enforces admission/deadline/breaker typing; the
        handler maps those onto 429/503/504 like /predict."""
        with self._lock:
            gen = self._generators.get(mid)
        if gen is None:
            raise UnknownModelError(
                f"unknown generation model '{mid}' — register it with "
                "attach_generation()")
        budget = deadline_s if deadline_s is not None \
            else self.request_deadline_s
        fut = gen.submit(np.asarray(prompt_ids, np.int64),
                         int(max_tokens), temperature=float(temperature),
                         top_k=int(top_k), seed=int(seed),
                         deadline_s=budget)
        try:
            # the server resolves deadlined requests itself; the extra
            # slack only guards a wedged loop thread from hanging HTTP
            out = fut.result(timeout=None if budget is None
                             else budget + 30.0)
        except Exception:
            self._m_failed.inc()
            raise
        self._m_completed.inc()
        return _host(out).tolist()

    def list_models(self) -> list:
        with self._lock:
            return sorted(self._models)

    def stats(self) -> dict:
        """Per-server serving counters (the /stats endpoint body): the
        observable surface for the UI, bench, and ops. Counters come off
        the registry; the legacy key set and order are preserved
        byte-for-byte."""
        out = {"retried": int(self._m_retried.value),
               "expired": int(self._m_expired.value),
               "rejected_circuit": int(self._m_rejected_circuit.value),
               "completed": int(self._m_completed.value),
               "failed": int(self._m_failed.value)}
        out.update(accepted=self.admission.accepted,
                   rejected=self.admission.rejected,
                   pending=self.admission.pending,
                   breaker_state=self.breaker.state)
        with self._lock:
            out["models"] = len(self._models)
            gens = dict(self._generators)
        with self._inference_lock:
            infs = dict(self._inference)
        if gens:
            # fleet-served models carry a "replicas" list here: per-replica
            # health score, breaker state, in-flight depth, restart count
            out["generation"] = {mid: g.stats() for mid, g in gens.items()}
            # crash-durable serving rollup: sum each generation target's
            # handoff block (fleet-served targets expose theirs on each
            # replica's server block instead) so ops reads one number
            handoff: dict = {}
            for st in out["generation"].values():
                blocks = [st["handoff"]] if "handoff" in st else [
                    rep["server"]["handoff"]
                    for rep in st.get("replicas", ())
                    if isinstance(rep.get("server"), dict)
                    and "handoff" in rep["server"]]
                for blk in blocks:
                    for k, v in blk.items():
                        handoff[k] = handoff.get(k, 0) + v
            if handoff:
                out["handoff"] = handoff
        if infs:
            out["inference"] = {mid: i.stats() for mid, i in infs.items()}
        return out

    def register_metrics(self, labels: Optional[dict],
                         registry: MetricsRegistry) -> None:
        """Expose an additional registry on GET /metrics (a broker's, a
        training health guard's, ...) with ``labels`` injected on every
        sample it contributes."""
        with self._lock:
            self._extra_metrics.append((dict(labels or {}), registry))

    def metrics_text(self) -> str:
        """Prometheus text exposition (0.0.4) over every registry this
        server can see: its own serving counters, each attached
        generation/inference target's registry labeled ``model=<id>``
        (a fleet contributes its fleet-level aggregates), any
        ``register_metrics`` extras, and the process-global registry
        (training/health telemetry). Duplicate registry objects render
        once — first labeling wins."""
        with self._lock:
            gens = dict(self._generators)
            extras = list(self._extra_metrics)
        with self._inference_lock:
            infs = dict(self._inference)
        sources = [({}, self.metrics)]
        seen = {id(self.metrics)}
        for mid, target in list(gens.items()) + list(infs.items()):
            reg = getattr(target, "metrics", None)
            if reg is not None and id(reg) not in seen:
                seen.add(id(reg))
                sources.append(({"model": mid}, reg))
        for labels, reg in extras:
            if id(reg) not in seen:
                seen.add(id(reg))
                sources.append((labels, reg))
        gl = global_registry()
        if id(gl) not in seen:
            sources.append(({}, gl))
        return render_text(sources)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, status=200):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, status, message, err_type):
                self._json({"error": message, "type": err_type}, status)

            def do_GET(self):
                if self.path == "/models":
                    self._json({"models": server.list_models()})
                elif self.path == "/stats":
                    self._json(server.stats())
                elif self.path == "/metrics":
                    body = server.metrics_text().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._error(404, "not found", "NotFound")

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    return self._error(400, "missing or malformed "
                                       "Content-Length", "BadRequest")
                if n > server.max_body_bytes:
                    # the cap bounds MEMORY, not the wire: the body is
                    # discarded in fixed-size chunks (never buffered) so
                    # the client — still blocked in send — can finish and
                    # read the 413 instead of dying on a broken pipe
                    left = n
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 16))
                        if not chunk:
                            break
                        left -= len(chunk)
                    return self._error(
                        413, f"request body of {n} bytes exceeds "
                        f"max_body_bytes={server.max_body_bytes}",
                        "BodyTooLarge")
                try:
                    req = json.loads(self.rfile.read(n))
                    if not isinstance(req, dict):
                        raise ValueError("JSON body must be an object")
                except (ValueError, UnicodeDecodeError) as e:
                    return self._error(400, f"malformed JSON body: {e}",
                                       "BadRequest")
                try:
                    if self.path == "/import":
                        self._json({"model":
                                    server.import_model(req["path"])})
                    elif self.path == "/fit":
                        self._json(server.fit(req["model"], req["batches"],
                                              int(req.get("epochs", 1))))
                    elif self.path == "/evaluate":
                        self._json(server.evaluate(req["model"],
                                                   req["batches"]))
                    elif self.path == "/predict":
                        self._json({"output": server.predict(
                            req["model"], req["features"],
                            req.get("deadline_s"))})
                    elif self.path == "/generate":
                        self._json({"tokens": server.generate(
                            req["model"], req["prompt_ids"],
                            int(req["max_tokens"]),
                            float(req.get("temperature", 0.0)),
                            int(req.get("top_k", 0)),
                            int(req.get("seed", 0)),
                            req.get("deadline_s"))})
                    elif self.path == "/rag":
                        self._json(server.rag(
                            req["model"], req["prompt_ids"],
                            int(req["max_tokens"]),
                            req.get("query_vec"),
                            req.get("k"),
                            float(req.get("temperature", 0.0)),
                            int(req.get("top_k", 0)),
                            int(req.get("seed", 0)),
                            req.get("deadline_s")))
                    else:
                        self._error(404, "not found", "NotFound")
                except UnknownModelError as e:
                    self._error(404, str(e.args[0] if e.args else e),
                                type(e).__name__)
                except tuple(_STATUS) as e:
                    status = next(s for c, s in _STATUS.items()
                                  if isinstance(e, c))
                    self._error(status, str(e), type(e).__name__)
                except (KeyError, TypeError, ValueError, OSError) as e:
                    # bad request shape / unreadable batch paths
                    self._error(400, f"{type(e).__name__}: {e}",
                                "BadRequest")
                except Exception as e:  # noqa: BLE001 — structured, not a
                    # traceback-driven blank 500
                    self._error(500, f"{type(e).__name__}: {e}",
                                "InternalError")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        with self._lock:
            gens = list(self._generators.values())
            self._generators.clear()
        with self._inference_lock:
            gens.extend(self._inference.values())
            self._inference.clear()
        for g in gens:
            g.close()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
