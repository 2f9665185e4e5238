"""TCP pub/sub topic broker for NDArray streams (port of
``deeplearning4j_tpu/streaming/broker.py``; host-side, no device work).

Reference semantics: the Kafka broker in dl4j-streaming's routes
(CamelKafkaRouteBuilder.java:16 wires record publishers to topic
consumers). This is the minimal broker that gives the same contract on
one machine or a LAN: named topics, many publishers, many subscribers
(every subscriber sees every frame — Kafka consumer-group-per-subscriber
semantics), bounded per-subscriber buffering with publisher backpressure,
and an explicit end-of-stream marker.

Wire protocol (all big-endian; byte for byte the JAX package's, so a
publisher, broker and consumer of either package interoperate):
    frame   = op(1) topic_len(2) topic payload_len(4) payload
    ops     : P publish data | E end-of-topic | S subscribe (payload "")
            | K subscribe-ack (broker -> subscriber, payload "")
A subscriber sends S and MUST read the K ack before treating the
connection as live; after the ack it receives the publisher's P/E frames
verbatim for its topic, with no frame published after the ack missed.

Run standalone: ``python -m deeplearning4j_torch.streaming.broker --port N``
or embedded: ``StreamingBroker(port=0).start()``.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Optional

from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.parallel.runtime import (EXIT, ServingLoop,
                                                   supervisor)

_HDR = struct.Struct(">cH")
_LEN = struct.Struct(">I")

OP_PUBLISH = b"P"
OP_END = b"E"
OP_SUBSCRIBE = b"S"
OP_SUB_ACK = b"K"

MAX_FRAME_BYTES = 1 << 30  # default defensive bound on payload_len


class FrameTooLarge(ValueError):
    """A frame's length prefix declared a payload above the reader's
    ``max_frame_bytes`` cap. A corrupt (or hostile) 4-byte length must
    be rejected typed BEFORE any allocation is attempted — trusting it
    turns one flipped bit into an unbounded ``recv`` buffer. Subclasses
    ``ValueError`` so pre-existing ``except (OSError, ValueError)``
    connection handlers keep dropping the poisoned connection."""


def read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(sock: socket.socket,
               max_frame_bytes: int = MAX_FRAME_BYTES):
    """(op, topic, payload) or None on clean EOF. A length prefix
    above ``max_frame_bytes`` fails typed ``FrameTooLarge`` — never an
    attempted allocation of attacker/corruption-controlled size."""
    hdr = read_exact(sock, _HDR.size)
    if hdr is None:
        return None
    op, tlen = _HDR.unpack(hdr)
    topic = read_exact(sock, tlen)
    if topic is None:
        return None
    raw = read_exact(sock, _LEN.size)
    if raw is None:
        return None
    (plen,) = _LEN.unpack(raw)
    if plen > max_frame_bytes:
        raise FrameTooLarge(f"frame of {plen} bytes exceeds the "
                            f"{max_frame_bytes}-byte bound")
    payload = read_exact(sock, plen) if plen else b""
    if payload is None:
        return None
    return op, topic.decode("utf-8"), payload


def write_frame(sock: socket.socket, op: bytes, topic: str,
                payload: bytes = b"") -> None:
    t = topic.encode("utf-8")
    sock.sendall(_HDR.pack(op, len(t)) + t + _LEN.pack(len(payload))
                 + payload)


class _Subscriber:
    def __init__(self, sock: socket.socket, topic: str, maxsize: int):
        self.sock = sock
        self.topic = topic
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.loop: Optional[ServingLoop] = None  # writer (set pre-register)
        self.alive = True
        self.dropped = 0            # frames this subscriber never received
        self.consecutive_drops = 0  # resets on every delivered frame
        self.registered = threading.Event()  # set once in the broker's _subs


class StreamingBroker:
    """Threaded topic broker. ``port=0`` picks a free port (see
    ``.port``). One writer thread per subscriber drains its bounded
    queue; a publish backpressures (blocks up to ``publish_patience_s``)
    while a live subscriber's queue is full — a slow consumer throttles
    the stream instead of exhausting broker memory, the same role Kafka's
    bounded log + consumer lag plays for the reference.

    A subscriber that stays full PAST the patience window no longer stalls
    every other subscriber silently: the frame is dropped *for that
    subscriber only*, counted (``stats()``), and after ``drop_limit``
    CONSECUTIVE drops the subscriber is disconnected (it can reconnect and
    resubscribe) — the Kafka consumer-eviction analog. Set
    ``publish_patience_s=None`` for the legacy block-forever backpressure
    (no drops, no eviction)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 subscriber_buffer: int = 16, drop_limit: int = 8,
                 publish_patience_s: Optional[float] = 0.5,
                 registry: Optional[MetricsRegistry] = None,
                 chaos=None):
        self.host = host
        self.port = port
        self.subscriber_buffer = subscriber_buffer
        self.drop_limit = max(1, int(drop_limit))
        self.publish_patience_s = publish_patience_s
        self._subs: dict = {}          # topic -> [_Subscriber]
        self._lock = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._accept: Optional[ServingLoop] = None
        self._threads: list = []
        self._stop = threading.Event()
        self._chaos = chaos
        # fan-out health counters live in the registry (leaf-locked);
        # broker _lock only guards subscriber bookkeeping
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._m_frames_dropped = self.metrics.counter(
            "broker_frames_dropped_total",
            "frames dropped for slow subscribers")
        self._m_subs_disconnected = self.metrics.counter(
            "broker_subscribers_disconnected_total",
            "slow-subscriber evictions")
        self._m_dropped_by_topic = self.metrics.counter(
            "broker_dropped_by_topic_total",
            "frames dropped per topic", labels=("topic",))
        self.metrics.gauge("broker_subscribers", "live subscribers",
                           fn=self._subscriber_count)

    def _subscriber_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._subs.values())

    def _track(self, t: threading.Thread) -> None:
        """Retain ``t`` for lifecycle introspection, pruning finished
        threads first: a long-lived broker serving N connect/disconnect
        cycles keeps O(live) entries, not O(N) dead Thread objects."""
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "StreamingBroker":
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._server.listen(64)
        self._accept = ServingLoop("broker-accept", tick=self._accept_tick,
                                   chaos=self._chaos)
        self._accept.start()
        self._track(self._accept.threads[-1])
        supervisor().watch(self._accept, on_death=self._on_accept_death,
                           restart=True)
        return self

    def stop(self) -> None:
        """Stop accepting, wake every writer, close every socket. Safe to
        call twice, concurrently, and on a never-started broker."""
        self._stop.set()
        if self._server is not None:
            try:
                # close() alone does NOT wake a thread already blocked in
                # accept() on Linux — shutdown() does (EINVAL in the
                # accepter), so the tick exits now instead of leaking
                # until the join deadline
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()  # accept() raises -> clean tick exit
            except OSError:
                pass
        if self._accept is not None:
            self._accept.close(timeout=1.0)
        with self._lock:
            subs = [s for ss in self._subs.values() for s in ss]
        for s in subs:
            s.alive = False
            try:
                s.sock.close()  # a writer stuck in sendall errors out
            except OSError:
                pass
            if s.loop is not None:
                # the sentinel wakes a writer blocked on an empty queue
                # (no 0.2 s polling); timeout 0 keeps stop() non-blocking
                s.loop.close(timeout=0)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every live subscriber's queue has been written out
        (the broker holds no undelivered frames). False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                subs = [s for ss in self._subs.values() for s in ss]
            if all(s.q.empty() for s in subs if s.alive):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def close(self, timeout: float = 30.0) -> None:
        """Drain undelivered frames, then stop the broker and join its
        runtime loops. Idempotent and re-entrant from any thread."""
        self.drain(timeout)
        with self._lock:
            subs = [s for ss in self._subs.values() for s in ss]
        self.stop()
        deadline = time.monotonic() + max(0.0, timeout)
        loops = [lp for lp in [self._accept] + [s.loop for s in subs]
                 if lp is not None]
        for lp in loops:
            for t in lp.threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _on_accept_death(self, loop, exc) -> bool:
        """Supervisor hook: restart the accept loop (same listening
        socket) unless the broker is deliberately stopping."""
        return not self._stop.is_set()

    # ------------------------------------------------------------- serving
    def _accept_tick(self) -> bool:
        try:
            conn, _ = self._server.accept()
        except OSError:
            return False  # listening socket closed: clean exit
        t = threading.Thread(target=self._serve, args=(conn,),
                             daemon=True)
        t.start()
        self._track(t)
        return True

    def _serve(self, conn: socket.socket):
        try:
            while True:
                frame = read_frame(conn)
                if frame is None:
                    return
                op, topic, payload = frame
                if op == OP_SUBSCRIBE:
                    self._add_subscriber(conn, topic)
                    return  # connection is now a subscriber: writer owns it
                if op in (OP_PUBLISH, OP_END):
                    self._fan_out(op, topic, payload)
        except (OSError, ValueError):
            pass
        finally:
            if not self._is_subscriber_sock(conn):
                try:
                    conn.close()
                except OSError:
                    pass

    def _is_subscriber_sock(self, conn):
        with self._lock:
            return any(s.sock is conn for ss in self._subs.values()
                       for s in ss)

    def _add_subscriber(self, conn: socket.socket, topic: str):
        sub = _Subscriber(conn, topic, self.subscriber_buffer)
        # the ack is queued BEFORE registration (the queue is private
        # until the sub is in _subs), so it is guaranteed to be frame #1,
        # and no racing publish can slip a data frame ahead of it; the
        # writer sends it only once the subscription is registered, so a
        # consumer that has read it can miss no later frame (the JAX
        # broker's writer may send it before registration: ROADMAP C14)
        sub.q.put((OP_SUB_ACK, b""))
        # the writer is an inbox-mode ServingLoop over the subscriber's
        # own (external) queue, started before registration so _disconnect
        # can never observe a subscriber without a writer loop
        sub.loop = ServingLoop(
            f"broker-writer-{topic}",
            handler=lambda item, s=sub: self._write_frame(s, item),
            inbox=sub.q,
            on_worker_exit=lambda lp, exc, s=sub: self._writer_exit(s),
            chaos=self._chaos)
        sub.loop.start()
        self._track(sub.loop.threads[-1])
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
        sub.registered.set()

    def _write_frame(self, sub: _Subscriber, item):
        """Writer handler: one frame out; EXIT retires the writer on
        end-of-topic or a dead consumer socket. The ack waits for the
        subscription's registration."""
        op, payload = item
        if op == OP_SUB_ACK and not sub.registered.wait(30.0):
            return EXIT
        try:
            write_frame(sub.sock, op, sub.topic, payload)
        except OSError:
            return EXIT
        if op == OP_END:
            return EXIT
        return None

    def _writer_exit(self, sub: _Subscriber) -> None:
        """Writer retired (end-of-topic, eviction, broker stop, or socket
        error): deregister the subscription and close out the socket."""
        sub.alive = False
        with self._lock:
            ss = self._subs.get(sub.topic, [])
            if sub in ss:
                ss.remove(sub)
        try:
            sub.sock.close()
        except OSError:
            pass

    def _fan_out(self, op: bytes, topic: str, payload: bytes):
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for s in subs:
            self._offer(s, op, payload)

    def _offer(self, s: _Subscriber, op: bytes, payload: bytes):
        """Deliver one frame to one subscriber with bounded backpressure:
        block up to ``publish_patience_s`` (forever when None), then drop
        the frame FOR THIS SUBSCRIBER, count it, and evict the subscriber
        after ``drop_limit`` consecutive drops."""
        limit = (None if self.publish_patience_s is None
                 else time.monotonic() + self.publish_patience_s)
        while s.alive and not self._stop.is_set():
            wait = 0.2 if limit is None else min(
                0.2, limit - time.monotonic())
            if wait <= 0:
                break
            try:
                s.q.put((op, payload), timeout=wait)  # backpressure
                s.consecutive_drops = 0
                return
            except queue.Full:
                continue
        if not s.alive or self._stop.is_set():
            return
        # the patience window closed with the queue still full: this frame
        # is lost to this subscriber — counted, never silent
        with self._lock:
            s.dropped += 1
            s.consecutive_drops += 1
            evict = s.consecutive_drops >= self.drop_limit
        self._m_frames_dropped.inc()
        self._m_dropped_by_topic.labels(topic=s.topic).inc()
        if evict:
            self._disconnect(s)

    def _disconnect(self, s: _Subscriber):
        """Evict a persistently-slow subscriber (it can reconnect): its
        writer thread exits on ``alive=False``, the socket close tells the
        consumer immediately (EOF) rather than leaving it waiting on
        frames that will never come."""
        s.alive = False
        with self._lock:
            ss = self._subs.get(s.topic, [])
            if s in ss:
                ss.remove(s)
        self._m_subs_disconnected.inc()
        try:
            s.sock.close()  # a writer stuck in sendall errors out
        except OSError:
            pass
        if s.loop is not None:
            # bounded: the sentinel wakes a writer blocked on get(); a
            # full queue is skipped (the writer exits via the socket
            # error above) so eviction never stalls the publisher
            s.loop.close(timeout=0)

    def stats(self) -> dict:
        """Fan-out health counters: live subscriber count, frames dropped
        for slow subscribers (total and per topic), and slow-subscriber
        evictions. Counters come off the registry, so the snapshot is
        assembled outside ``_lock``."""
        return {
            "subscribers": self._subscriber_count(),
            "frames_dropped": int(self._m_frames_dropped.value),
            "subscribers_disconnected":
                int(self._m_subs_disconnected.value),
            "dropped_by_topic": {
                lbls["topic"]: int(m.value)
                for lbls, m in self._m_dropped_by_topic.samples()},
        }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9092)
    ap.add_argument("--buffer", type=int, default=16,
                    help="per-subscriber frame buffer (backpressure bound)")
    ap.add_argument("--drop-limit", type=int, default=8,
                    help="consecutive dropped frames before a slow "
                         "subscriber is disconnected")
    ap.add_argument("--patience", type=float, default=0.5,
                    help="seconds a publish backpressures on a full "
                         "subscriber queue before dropping the frame "
                         "(<=0: block forever, legacy behavior)")
    args = ap.parse_args(argv)
    broker = StreamingBroker(
        args.host, args.port, args.buffer, drop_limit=args.drop_limit,
        publish_patience_s=None if args.patience <= 0 else args.patience,
    ).start()
    print(f"streaming broker listening on {broker.host}:{broker.port}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        broker.stop()


if __name__ == "__main__":
    main()
