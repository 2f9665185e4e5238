"""Publisher/consumer clients + the route builder (port of
``deeplearning4j_tpu/streaming/client.py``; host-side, no device work).

Reference: streaming/kafka/NDArrayPublisher.java (publish NDArrays to a
topic), kafka/NDArrayConsumer.java (getArrays/consume), and
routes/CamelKafkaRouteBuilder.java:16 (wire a record stream into
training). The transport is the in-repo TCP broker
(streaming/broker.py); the payloads are npz-encoded DataSets
(streaming/serde.py). A route's batches are host DataSets; ``fit`` copies
them to the net's device.
"""

from __future__ import annotations

import socket
import threading
from typing import Iterator, Optional

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.streaming import QueueDataSetIterator
from deeplearning4j_torch.streaming.broker import (
    OP_END,
    OP_PUBLISH,
    OP_SUB_ACK,
    OP_SUBSCRIBE,
    read_frame,
    write_frame,
)
from deeplearning4j_torch.streaming.serde import (
    dataset_from_bytes,
    dataset_to_bytes,
)


class StreamStalled(RuntimeError):
    """A consumer saw no frame within its ``idle_timeout_s`` — the broker
    or publisher is presumed dead/wedged. Raised instead of surfacing a
    silent early end-of-stream to ``fit()``. Defined here (not in
    parallel/resilience.py, which re-exports it into the serving error
    taxonomy) so streaming stays importable without the parallel stack."""


class NDArrayPublisher:
    """Publish DataSet minibatches to a broker topic
    (NDArrayPublisher.java analog; also usable as a context manager)."""

    def __init__(self, host: str, port: int, topic: str,
                 connect_timeout: Optional[float] = 30.0):
        self.topic = topic
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        # the timeout bounds CONNECT only: a publish blocked on broker
        # backpressure for minutes is the documented contract, not an
        # error — the socket must block indefinitely after connect
        self._sock.settimeout(None)

    def publish(self, ds: DataSet) -> None:
        write_frame(self._sock, OP_PUBLISH, self.topic, dataset_to_bytes(ds))

    def publish_arrays(self, features, labels) -> None:
        self.publish(DataSet(features, labels))

    def end(self) -> None:
        """Signal end-of-stream to every subscriber of the topic."""
        write_frame(self._sock, OP_END, self.topic)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NDArrayConsumer:
    """Subscribe to a topic and iterate arriving DataSets until the
    publisher ends the stream (NDArrayConsumer.java analog).

    ``idle_timeout_s`` bounds the wait for the NEXT frame: a dead broker
    otherwise hangs ``__iter__`` forever on a ``settimeout(None)`` socket.
    On idle timeout the iterator raises ``StreamStalled`` — a typed,
    diagnosable failure — rather than hanging or (worse) surfacing a
    silent early end-of-stream to ``fit()``. Default ``None`` keeps the
    block-indefinitely contract for live feeds with long producer idles."""

    def __init__(self, host: str, port: int, topic: str,
                 connect_timeout: Optional[float] = 30.0,
                 idle_timeout_s: Optional[float] = None):
        self.topic = topic
        self.idle_timeout_s = idle_timeout_s
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        try:
            # the handshake stays under connect_timeout (a wedged broker
            # must not hang construction forever)
            write_frame(self._sock, OP_SUBSCRIBE, topic)
            # wait for the broker's registration ack: after this, no
            # frame published to the topic can be missed
            frame = read_frame(self._sock)
            if frame is None or frame[0] != OP_SUB_ACK:
                raise ConnectionError(
                    f"broker did not acknowledge subscription to "
                    f"'{topic}'")
        except BaseException:
            self._sock.close()  # no object escapes: close or leak the fd
            raise
        # from here on, the wait-per-frame policy is the caller's choice:
        # None blocks indefinitely (a producer idling minutes between
        # publishes is normal for a live training feed), a bound turns a
        # dead broker into a typed StreamStalled instead of a silent hang
        self._sock.settimeout(idle_timeout_s)

    def __iter__(self) -> Iterator[DataSet]:
        while True:
            try:
                frame = read_frame(self._sock)
            except socket.timeout:
                raise StreamStalled(
                    f"no frame on topic '{self.topic}' within the "
                    f"{self.idle_timeout_s}s idle timeout — broker or "
                    "publisher presumed dead") from None
            if frame is None:
                return  # broker gone: treat as stream end
            op, _, payload = frame
            if op == OP_END:
                return
            yield dataset_from_bytes(payload)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NDArrayRoute:
    """CamelKafkaRouteBuilder analog: one call wires a broker topic into
    a training-ready iterator. A background thread drains the consumer
    into a bounded QueueDataSetIterator (push-queue backpressure), so
    ``route.iterator()`` plugs straight into ``net.fit(...)`` while a
    producer in another process keeps publishing."""

    def __init__(self, host: str, port: int, topic: str,
                 buffer_batches: int = 16):
        self.consumer = NDArrayConsumer(host, port, topic)
        self._it = QueueDataSetIterator(maxsize=buffer_batches)
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name=f"route-{topic}")
        self._thread.start()

    def _pump(self):
        try:
            for ds in self.consumer:
                self._it.put(ds)
        finally:
            self._it.end()
            self.consumer.close()

    def iterator(self) -> QueueDataSetIterator:
        return self._it

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
