"""Asynchronous parameter-server data parallelism (port of
``deeplearning4j_tpu/parallel/parameter_server.py``).

Reference: deeplearning4j-scaleout-parallelwrapper-parameter-server —
ParameterServerTrainer.java:32,48,68 (after each worker fit,
``pushNDArray(model.params())``; pull to resync) and
ParameterServerTrainerContext.java:43,66 (an embedded Aeron MediaDriver and
ParameterServerNode).

The Aeron UDP transport becomes stdlib HTTP with an in-process fast path;
the server is a thread-safe averaging store (async staleness semantics:
workers push whenever they finish a fit and pull before the next, no
barrier). Threshold compression (``optimize/accumulation.py``) is wired
into the push path: with ``compress=True`` a worker pushes
threshold-quantised sparse DELTAS (index + sign wire form, the
error-feedback residual kept worker-side on its net's device; reference:
EncodingHandler.java:65 encode, :91 broadcast) and the server applies
them. The wire bytes are the JAX package's, so either package's client
talks to either package's server. The store is host numpy: the pushed
vectors are the flat parameters each worker fetched from its card.
"""

from __future__ import annotations

import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeplearning4j_torch.optimize.accumulation import (EncodingHandler,
                                                        sparsify)


def _pack_sparse(idx: np.ndarray, signs: np.ndarray, threshold: float,
                 size: int) -> bytes:
    """Wire form of a threshold-encoded delta: threshold (f32), logical
    size (i64), nnz (i32), the int32 indices, then the packed sign bits."""
    return (struct.pack("<fqi", float(threshold), int(size), int(idx.size))
            + np.asarray(idx, np.int32).tobytes()
            + np.packbits(np.asarray(signs, bool)).tobytes())


def _unpack_sparse(raw: bytes):
    threshold, size, nnz = struct.unpack_from("<fqi", raw)
    off = struct.calcsize("<fqi")
    idx = np.frombuffer(raw, np.int32, count=nnz, offset=off)
    off += 4 * nnz
    signs = np.unpackbits(
        np.frombuffer(raw, np.uint8, offset=off))[:nnz].astype(bool)
    return idx, signs, threshold, size


class ParameterServer:
    """In-process parameter store with running-average updates (ND4J
    ParameterServerNode's soft sync: pushed params are averaged into the
    current state)."""

    def __init__(self, initial, alpha: float = 0.5):
        self._params = np.asarray(initial, np.float32).copy()
        self._alpha = alpha
        self._lock = threading.Lock()
        self._httpd = None
        self.pushes = 0

    def push(self, flat) -> None:
        with self._lock:
            self._params = ((1.0 - self._alpha) * self._params
                            + self._alpha * np.asarray(flat, np.float32))
            self.pushes += 1

    def push_sparse_delta(self, idx, signs, threshold: float) -> None:
        """Apply a threshold-encoded delta: params[idx] += ±threshold (the
        decode side of EncodingHandler's broadcast)."""
        with self._lock:
            np.add.at(self._params, np.asarray(idx),
                      np.where(np.asarray(signs), threshold, -threshold))
            self.pushes += 1

    def pull(self) -> np.ndarray:
        with self._lock:
            return self._params.copy()

    # ------------------------------------------------------------ HTTP front
    def serve(self, port: int = 0) -> int:
        """Expose push/pull over HTTP on 127.0.0.1 (the Aeron-replacement
        transport); returns the bound port."""
        ps = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = ps.pull().tobytes()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if self.path.rstrip("/").endswith("delta"):
                    idx, signs, threshold, _ = _unpack_sparse(raw)
                    ps.push_sparse_delta(idx, signs, threshold)
                else:
                    ps.push(np.frombuffer(raw, np.float32))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class ParameterServerClient:
    """ND4J ParameterServerClient (pushNDArray/getArray): HTTP or direct
    in-process."""

    def __init__(self, server: Optional[ParameterServer] = None,
                 address: Optional[str] = None):
        if (server is None) == (address is None):
            raise ValueError("Pass exactly one of server / address")
        self.server = server
        self.address = address

    def push(self, flat) -> None:
        if self.server is not None:
            self.server.push(flat)
            return
        import urllib.request

        req = urllib.request.Request(
            self.address, data=np.asarray(flat, np.float32).tobytes(),
            method="POST")
        urllib.request.urlopen(req, timeout=10).read()

    def push_sparse_delta(self, idx, signs, threshold: float,
                          size: int) -> None:
        if self.server is not None:
            self.server.push_sparse_delta(np.asarray(idx),
                                          np.asarray(signs), threshold)
            return
        import urllib.request

        req = urllib.request.Request(
            self.address.rstrip("/") + "/delta",
            data=_pack_sparse(np.asarray(idx), np.asarray(signs), threshold,
                              size),
            method="POST")
        urllib.request.urlopen(req, timeout=10).read()

    def pull(self) -> np.ndarray:
        if self.server is not None:
            return self.server.pull()
        import urllib.request

        raw = urllib.request.urlopen(self.address, timeout=10).read()
        return np.frombuffer(raw, np.float32)


class ParameterServerTrainer:
    """Worker-side trainer (ParameterServerTrainer.java:32: fit a batch,
    push params, pull to resync). ``compress=True`` pushes
    threshold-encoded sparse deltas with an error-feedback residual: after
    the local fit, delta = params_after - params_pulled (+ residual) is
    quantised to ±threshold where it crosses the threshold, the sparse
    (idx, sign) message goes over the wire and the remainder stays in the
    residual. ``message_density`` records nnz/size per push."""

    def __init__(self, net, client: ParameterServerClient,
                 compress: bool = False, threshold: float = 1e-3):
        self.net = net
        self.client = client
        self.compress = compress
        self.threshold = threshold
        self._encoder = EncodingHandler(threshold)
        self.message_density: list = []

    def fit(self, ds) -> None:
        pulled = self.client.pull()
        self.net.set_params_flat(pulled)
        self.net.fit(ds)
        after = np.asarray(self.net.params_flat(), np.float32)
        if not self.compress:
            self.client.push(after)
            return
        msg = self._encoder.encode(after - pulled)
        idx, signs = sparsify(msg, self.threshold)
        self.message_density.append(idx.size / max(int(msg.numel()), 1))
        self.client.push_sparse_delta(idx, signs, self.threshold,
                                      int(msg.numel()))


class ParameterServerParallelWrapper:
    """Thread-per-worker async data parallelism (the topology of
    ParameterServerParallelWrapperTest: N trainers, one embedded server).
    Each worker owns a replica of the net on the net's device; batches go
    round-robin."""

    def __init__(self, net, workers: int = 2, alpha: float = 0.5,
                 compress: bool = False, threshold: float = 1e-3):
        self.net = net
        self.server = ParameterServer(net.params_flat(), alpha=alpha)
        self.replicas = [net.clone() for _ in range(workers)]
        self.trainers = [
            ParameterServerTrainer(r, ParameterServerClient(self.server),
                                   compress=compress, threshold=threshold)
            for r in self.replicas]

    def fit(self, iterator, epochs: int = 1):
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            batches = list(iterator)
            per = [batches[i::len(self.trainers)]
                   for i in range(len(self.trainers))]
            errors: list = []

            def work(trainer, mine):
                try:
                    for ds in mine:
                        trainer.fit(ds)
                except BaseException as e:  # noqa: BLE001 - re-raised
                    errors.append(e)

            threads = [threading.Thread(target=work, args=(t, mine))
                       for t, mine in zip(self.trainers, per)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if errors:
                raise errors[0]
        self.net.set_params_flat(self.server.pull())
        return self.net
