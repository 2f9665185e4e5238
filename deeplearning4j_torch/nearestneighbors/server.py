"""REST k-NN service with the full production serving posture (the port of
``deeplearning4j_torch/nearestneighbors/server.py``).

Reference: deeplearning4j-nearestneighbor-server
(server/NearestNeighborsServer.java + NearestNeighbor.java — Play REST,
base64 NDArray payloads). Here: stdlib http.server + JSON vectors (no
base64-NDArray legacy), same endpoints in spirit plus the serving tier:

- POST /knn        {"k": 3, "point": [..]}          -> single query
                   (or {"points": [[..], ..]} for a batch)
- POST /knnVector  {"k": 3, "points": [[..], ..]}   -> batched
- POST /encode     {"docs": [[..], ..], "add": true} -> encode (+store)
- GET  /status     -> {"points": N, "dims": D}       (back-compat shape)
- GET  /stats      -> serving + index counters
- GET  /metrics    -> Prometheus exposition

Three backends share the surface: ``vptree`` (host, reference-style
pruning tree; its batched queries run brute force on the card),
``device`` (exact brute force, brute.py), and ``index`` (EmbeddingIndex,
index.py — coalesced submits, int8/IVF/HNSW stores). Every backend runs
on the card unless the caller passes ``device="cpu"``; ``mesh=`` (with
``backend="index"``) serves a store sharded over the mesh's data entries.
All of them get the hardened HTTP layer (KerasBackendServer's posture):
malformed/ragged payloads, non-numeric or non-positive k, and dims
mismatches return structured 400s; bodies over ``max_body_bytes`` are
discarded unbuffered and answered 413; the resilience taxonomy maps to
429/503/504. The accept pump is a supervised ``ServingLoop`` tick, not a
raw thread, so the HTTP front end rides the same lifecycle (and chaos)
as every other server in the repo.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.metrics.exposition import CONTENT_TYPE, render_text
from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.parallel.resilience import (CircuitOpen,
                                                    DeadlineExceeded,
                                                    ServerOverloaded,
                                                    TransientDispatchError)
from deeplearning4j_torch.parallel.runtime import (LoopClosed, LoopCrashed,
                                                 ServingLoop, supervisor)

#: typed serving failure -> (HTTP status, wire label). Order matters for
#: subclass matching (first isinstance wins).
_STATUS = {
    DeadlineExceeded: (504, "DeadlineExceeded"),
    ServerOverloaded: (429, "ServerOverloaded"),
    CircuitOpen: (503, "CircuitOpen"),
    TransientDispatchError: (503, "TransientDispatch"),
    LoopCrashed: (503, "Restarting"),
    LoopClosed: (503, "ShuttingDown"),
}


class _HttpError(Exception):
    """Validation failure carrying its HTTP status + wire label."""

    def __init__(self, status: int, label: str, detail: str):
        super().__init__(detail)
        self.status = status
        self.label = label
        self.detail = detail


class NearestNeighborsServer:
    """``backend="vptree"`` (host, reference-style pruning tree),
    ``backend="device"`` (exact brute force: one matmul + top-k per
    query batch), or ``backend="index"`` (EmbeddingIndex: coalesced
    submits, f32/int8/HNSW store, optional IVF partitions, full
    resilience posture). Passing ``index=`` adopts a pre-built
    EmbeddingIndex (and implies ``backend="index"``). ``device``: the
    card every backend searches on (CUDA unless the caller passes
    another device; an adopted index keeps its own)."""

    # the accept pump (ServingLoop tick) reads the httpd handle
    # lock-free between rounds; stop() swaps it out under ``_lock``
    _LOOP_OWNED = ("_httpd",)
    _LOOP_LOCK = "_lock"

    def __init__(self, points=None, port: int = 0,
                 metric: str = "euclidean", backend: str = "vptree", *,
                 index=None, encoder=None, store: str = "f32",
                 partitions: Optional[int] = None, nprobe: int = 8,
                 mesh=None, max_body_bytes: int = 8 << 20,
                 default_deadline_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device=None, **index_kwargs):
        if index is not None:
            backend = "index"
            device = index.device
        if mesh is not None and backend == "index" and index is None:
            # the sharded store lives on the mesh's data entries; the
            # host copies and the merge run on the first of them
            from deeplearning4j_torch.parallel.mesh import data_devices

            device = data_devices(mesh)[0]
        self.device = resolve_device(device)
        if backend == "vptree":
            from deeplearning4j_torch.clustering.vptree import VPTree

            self.tree = VPTree(np.asarray(points, np.float64),
                               metric=metric)
        elif backend == "device":
            from deeplearning4j_torch.nearestneighbors.brute import (
                DeviceBruteForceIndex,
            )

            # the index keeps its own f32 device copy; no host copy pinned
            self.tree = DeviceBruteForceIndex(points, metric=metric,
                                              device=self.device)
        elif backend == "index":
            self.tree = None
        else:
            raise ValueError(
                f"backend must be vptree|device|index, got '{backend}'")
        self.backend = backend
        self._own_index = index is None
        if backend == "index":
            if index is None:
                from deeplearning4j_torch.nearestneighbors.index import (
                    EmbeddingIndex,
                )

                index = EmbeddingIndex(points, metric, store=store,
                                       encoder=encoder, mesh=mesh,
                                       partitions=partitions, nprobe=nprobe,
                                       device=self.device, **index_kwargs)
            self.index = index
        else:
            self.index = None
        if points is not None:
            points = np.asarray(points)
            self.shape = points.shape
        else:
            self.shape = None
        self.max_body_bytes = int(max_body_bytes)
        self.default_deadline_s = default_deadline_s
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "knn_http_requests_total", "HTTP requests received")
        self._m_errors = self.metrics.counter(
            "knn_http_errors_total", "HTTP requests answered non-2xx")
        self._m_http_latency = self.metrics.histogram(
            "knn_http_latency_ms", "request receive-to-response latency")
        self._port = port
        self._httpd = None
        self._loop: Optional[ServingLoop] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- queries
    def _status_dims(self):
        if self.backend == "index":
            return self.index.n_points, self.index.dims
        return int(self.shape[0]), int(self.shape[1])

    def knn(self, queries, k: int, deadline_s: Optional[float] = None):
        """(distances [Q, k'], indices [Q, k']) with k' = min(k, N) — the
        uniform query core behind /knn and /knnVector. The index backend
        goes through the coalescer (so concurrent HTTP handlers merge
        into one device dispatch); vptree/device answer synchronously."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if self.backend == "index":
            fut = self.index.submit(q, k, deadline_s=deadline_s)
            return fut.result(
                None if deadline_s is None else deadline_s + 30.0)
        n, _d = self._status_dims()
        k = min(int(k), n)
        if self.backend == "device":
            return self.tree.search_batch_arrays(q, k)
        batches = self.tree.search_batch(q, k, device=self.device)
        d = np.asarray([[p[0] for p in b] for b in batches], np.float64)
        idx = np.asarray([[p[1] for p in b] for b in batches], np.int64)
        return d, idx

    def stats(self) -> dict:
        n, d = self._status_dims()
        out = {"backend": self.backend, "points": n, "dims": d,
               "requests": int(self._m_requests.value),
               "errors": int(self._m_errors.value)}
        if self.index is not None:
            out["index"] = self.index.stats()
        return out

    def metrics_text(self) -> str:
        """Prometheus exposition over the server registry and (when
        distinct) the index's — deduped by identity so a shared registry
        renders once."""
        sources = [({}, self.metrics)]
        if self.index is not None \
                and self.index.metrics is not self.metrics:
            sources.append(({}, self.index.metrics))
        return render_text(sources)

    # ------------------------------------------------------------ handlers
    def _check_k(self, req) -> int:
        k = req.get("k", 1)
        if isinstance(k, bool) or not isinstance(k, (int, float)) \
                or (isinstance(k, float) and not k.is_integer()):
            raise _HttpError(400, "BadRequest",
                             f"k must be a positive integer, got {k!r}")
        k = int(k)
        if k < 1:
            raise _HttpError(400, "BadRequest", f"k must be >= 1, got {k}")
        return k

    def _check_vectors(self, req, field: str, ndim: int) -> np.ndarray:
        if field not in req:
            raise _HttpError(400, "BadRequest",
                             f"missing required field '{field}'")
        try:
            arr = np.asarray(req[field], dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise _HttpError(400, "BadRequest",
                             f"'{field}' must be rectangular numeric "
                             f"rows: {e}") from e
        if arr.ndim != ndim or arr.size == 0:
            raise _HttpError(400, "BadRequest",
                             f"'{field}' must be a non-empty "
                             f"{ndim}-d array, got shape {arr.shape}")
        _n, dims = self._status_dims()
        if arr.shape[-1] != dims:
            raise _HttpError(400, "BadRequest",
                             f"dims mismatch: index is D={dims}, "
                             f"got D={arr.shape[-1]}")
        return arr

    def _handle_knn(self, req: dict) -> dict:
        k = self._check_k(req)
        if "point" in req:
            q = self._check_vectors(req, "point", 1)[None, :]
        else:
            q = self._check_vectors(req, "points", 2)
        d, idx = self.knn(q, k, req.get("deadline_s"))
        results = [[{"index": int(i), "distance": float(dd)}
                    for dd, i in zip(dr, ir)] for dr, ir in zip(d, idx)]
        if "point" in req:
            return {"results": results[0]}
        return {"results": results}

    def _handle_knn_vector(self, req: dict) -> dict:
        k = self._check_k(req)
        q = self._check_vectors(req, "points", 2)
        d, idx = self.knn(q, k, req.get("deadline_s"))
        return {"results": [[{"index": int(i), "distance": float(dd)}
                             for dd, i in zip(dr, ir)]
                            for dr, ir in zip(d, idx)]}

    def _handle_encode(self, req: dict) -> dict:
        if self.backend != "index":
            raise _HttpError(400, "BadRequest",
                             "/encode requires backend='index'")
        field = "docs" if "docs" in req else "points"
        if field not in req:
            raise _HttpError(400, "BadRequest",
                             "missing required field 'docs'")
        try:
            docs = np.asarray(req[field], dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise _HttpError(400, "BadRequest",
                             f"'{field}' must be numeric rows: {e}") from e
        if docs.ndim == 1:
            docs = docs[None, :]
        vecs = self.index.encode(docs)
        added = 0
        if req.get("add"):
            added = docs.shape[0]
            self.index.add(vecs)
        return {"vectors": vecs.tolist(), "added": added}

    # ----------------------------------------------------------- lifecycle
    @property
    def port(self) -> int:
        httpd = self._httpd
        return httpd.server_address[1] if httpd else self._port

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

            def _read_body(self) -> bytes:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    raise _HttpError(400, "BadRequest",
                                     "bad Content-Length") from None
                if n > server.max_body_bytes:
                    # unbuffered chunked discard: drain the wire without
                    # ever materializing the oversized body
                    left = n
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 16))
                        if not chunk:
                            break
                        left -= len(chunk)
                    raise _HttpError(
                        413, "BodyTooLarge",
                        f"body of {n} bytes exceeds max_body_bytes="
                        f"{server.max_body_bytes}")
                return self.rfile.read(n)

            def do_GET(self):
                server._m_requests.inc()
                if self.path == "/status":
                    n, d = server._status_dims()
                    self._json({"points": n, "dims": d})
                elif self.path == "/stats":
                    self._json(server.stats())
                elif self.path == "/metrics":
                    body = server.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    server._m_errors.inc()
                    self._json({"error": "NotFound",
                                "detail": "no such endpoint"}, 404)

            def do_POST(self):
                t0 = time.monotonic()
                server._m_requests.inc()
                try:
                    body = self._read_body()
                    try:
                        req = json.loads(body)
                    except json.JSONDecodeError as e:
                        raise _HttpError(400, "BadRequest",
                                         f"bad json: {e}") from e
                    if not isinstance(req, dict):
                        raise _HttpError(400, "BadRequest",
                                         "body must be a JSON object")
                    if self.path == "/knn":
                        out = server._handle_knn(req)
                    elif self.path == "/knnVector":
                        out = server._handle_knn_vector(req)
                    elif self.path == "/encode":
                        out = server._handle_encode(req)
                    else:
                        raise _HttpError(404, "NotFound",
                                         "no such endpoint")
                except _HttpError as e:
                    server._m_errors.inc()
                    self._json({"error": e.label, "detail": e.detail},
                               e.status)
                except tuple(_STATUS) as e:
                    server._m_errors.inc()
                    code, label = next(s for c, s in _STATUS.items()
                                       if isinstance(e, c))
                    self._json({"error": label, "detail": str(e)}, code)
                except (KeyError, TypeError, ValueError, OSError) as e:
                    server._m_errors.inc()
                    self._json({"error": "BadRequest", "detail": str(e)},
                               400)
                except Exception as e:  # noqa: BLE001 — structured 500
                    server._m_errors.inc()
                    self._json({"error": "InternalError",
                                "detail": f"{type(e).__name__}: {e}"}, 500)
                else:
                    self._json(out)
                finally:
                    server._m_http_latency.observe(
                        (time.monotonic() - t0) * 1e3)

        with self._lock:
            if self._httpd is not None:
                return self.port
            httpd = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
            httpd.daemon_threads = True
            # bounded accept wait: the supervised tick re-checks loop
            # state every handle_request() return
            httpd.timeout = 0.1
            self._httpd = httpd
            loop = ServingLoop("knn-http", tick=self._http_tick)
            self._loop = loop
        loop.start()
        supervisor().watch(loop, on_death=self._on_http_death, restart=True)
        return self.port

    def _http_tick(self) -> bool:
        """Accept pump: one bounded-wait accept per tick. Hosted on a
        supervised ServingLoop so the HTTP front end shares the uniform
        lifecycle (drain/close/chaos) instead of a raw daemon thread."""
        httpd = self._httpd
        if httpd is None:
            return False  # stop() swapped the handle out: exit cleanly
        httpd.handle_request()
        return True

    def _on_http_death(self, loop: ServingLoop, exc: BaseException) -> bool:
        return self._httpd is not None  # restart unless stopping

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the accept pump, close the socket, and (when this server
        built its own index) close the index. Idempotent."""
        with self._lock:
            loop, httpd = self._loop, self._httpd
            self._loop = None
            self._httpd = None
        if loop is not None:
            loop.close(timeout)
        if httpd is not None:
            httpd.server_close()
        if self._own_index and self.index is not None:
            self.index.close(timeout)

    def close(self, timeout: float = 10.0) -> None:
        """ReplicaFleet-compatible alias for ``stop``."""
        self.stop(timeout)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
