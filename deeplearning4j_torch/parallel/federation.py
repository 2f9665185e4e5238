"""Cross-host fleet federation: survive whole-process death with
bit-exact cross-host migration (port of
``deeplearning4j_tpu/parallel/federation.py``).

``FleetFederation`` is a router in front of N ``FleetHost`` processes,
each wrapping a full ``ReplicaFleet`` behind a length-prefixed framed
RPC (submit / adopt / stats / retire / drain). The hosts are separate
Python processes on localhost sockets (``spawn_host`` launches ``python
-m deeplearning4j_torch.parallel.federation --spec ...``); every failure
the router handles (a refused connect, a half-open link, a SIGKILLed
process mid-stream) is the real kernel artifact, not a mock.

* **Routing** mirrors ``ReplicaFleet._route_once`` one level up:
  ``score = (inflight + 1) * max(ewma_ms, 0.5) * (1 + 8 * fail_ewma)``
  per host, with a per-host ``CircuitBreaker`` + ``RetryPolicy`` and the
  remaining deadline sent on every RPC.

* **Health gossip** rides ``parallel.elastic``: each host process writes
  a ``Heartbeat`` file; the router's ``FailureDetector`` answers a short
  *suspect* question and a long *dead* question off one observation
  table, so a wedged host is marked SUSPECT on missed beats before any
  TCP error surfaces. Periodic ``stats`` RPCs roll every host's fleet
  stats and metrics families up to the router, so one scrape of
  ``metrics_sources()`` through ``metrics.exposition.render_text`` shows
  every host under an injected ``host=`` label.

* **Crash robustness**: hosts publish each in-flight request's newest
  periodic ``KVSnapshot`` (``snapshot_every=`` exports mirrored onto the
  fleet future by ``ReplicaFleet._monitor_tick``) to the router as
  opaque wire-v3 bytes. When a host process dies mid-stream the router
  re-adopts each victim's newest snapshot on a surviving host through
  ``ReplicaFleet.adopt``; the completion is bit-exact either way (the
  fold_in key schedule makes token-0 regeneration exact), a checksum or
  geometry refusal falls back to token 0, and the federated ledger
  balances: ``submitted == completed + failed + expired +
  rejected_submits`` with zero lost futures.

* **Degraded mode**: a multi-host federation down to <= 1 READY host
  raises the ``fed_degraded_mode`` gauge and logs once per flip,
  clearing itself when a host recovers.

The router never touches device state: snapshots cross it as opaque
bytes, parsed header-only (``peek_snapshot``) for observability. Frames
are byte for byte the JAX module's, so either package's router talks to
either package's hosts. A host process runs its fleet on the device its
spec names: the card unless the spec asks for the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.parallel.elastic import FailureDetector, Heartbeat
from deeplearning4j_torch.parallel.fleet import ReplicaFleet
from deeplearning4j_torch.parallel.handoff import (KVSnapshot, SnapshotError,
                                                 peek_snapshot)
from deeplearning4j_torch.parallel.resilience import (
    AdmissionController, ChaosPolicy, CircuitBreaker, CircuitOpen,
    Deadline, DeadlineExceeded, ReplicaKilled, ReplicaUnavailable,
    ResilienceError, RetryPolicy, ServerOverloaded,
    TransientDispatchError)
from deeplearning4j_torch.parallel.runtime import EXIT, ServingLoop, supervisor
from deeplearning4j_torch.streaming.broker import FrameTooLarge, read_exact

log = logging.getLogger(__name__)

__all__ = ["FleetFederation", "FleetHost", "HostHandle", "HostUnavailable",
           "FederationProtocolError", "spawn_host", "build_generation_fleet",
           "FED_MAX_FRAME_BYTES", "READY", "SUSPECT", "DEAD", "RETIRED"]

# host lifecycle states (router's view)
READY = "ready"
SUSPECT = "suspect"      # missed heartbeats / failed gossip, link not dead
DEAD = "dead"            # link down or heartbeat verdict; awaiting reconnect
RETIRED = "retired"      # deliberate removal; never reconnected

#: default defensive bound on one federation RPC frame — far above any
#: control message, comfortably above a test-scale KV snapshot, far
#: below the broker's 1 GiB streaming bound
FED_MAX_FRAME_BYTES = 1 << 26

_U32 = struct.Struct(">I")

_UNSET = object()


class HostUnavailable(ReplicaUnavailable):
    """No federated host can accept the request (all dead, suspect,
    retired, or refusing). HTTP mapping: 503."""


class FederationProtocolError(ResilienceError):
    """A federation RPC frame failed structural validation (bad header
    length, unreadable JSON, missing ``op``). The receiving side answers
    with a best-effort ``protocol_error`` frame and CLOSES the
    connection — after a corrupt frame the stream offsets can no longer
    be trusted. HTTP mapping: 502."""


# typed errors a host can report over the wire, reconstructed router-side
_WIRE_ERRORS: Dict[str, type] = {
    "DeadlineExceeded": DeadlineExceeded,
    "ServerOverloaded": ServerOverloaded,
    "CircuitOpen": CircuitOpen,
    "ReplicaUnavailable": ReplicaUnavailable,
    "ReplicaKilled": ReplicaKilled,
    "TransientDispatchError": TransientDispatchError,
    "HostUnavailable": HostUnavailable,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}

#: error types that mean "this host shed the request" — re-route, count
#: against the host breaker, but do not poison the link
_SHED_ERRORS = ("ServerOverloaded", "CircuitOpen", "ReplicaUnavailable",
                "HostUnavailable")


# --------------------------------------------------------------- framing

def _send_msg(sock: socket.socket, header: dict, blob: bytes = b"", *,
              chaos: Any = None,
              max_frame_bytes: int = FED_MAX_FRAME_BYTES) -> None:
    """One federation frame out: ``u32 payload_len | u32 header_len |
    JSON header | blob``.  The router-side ``ChaosPolicy`` network hooks
    fire here: an active partition window (or a fresh partition draw)
    raises ``OSError`` without writing a byte; a corrupt draw flips one
    bit inside the header-length field so the receiver's structural
    validation — not a crash — rejects the frame."""
    hb = json.dumps(header).encode()
    payload = _U32.pack(len(hb)) + hb + blob
    if len(payload) > max_frame_bytes:
        raise FrameTooLarge(
            f"frame of {len(payload)} bytes exceeds the "
            f"{max_frame_bytes}-byte bound")
    frame = _U32.pack(len(payload)) + payload
    if chaos is not None:
        if chaos.net_partitioned():
            raise OSError("chaos: link partitioned")
        mode = chaos.net_fault_mode(len(frame))
        if mode == "partition":
            raise OSError("chaos: link partitioned")
        if mode == "corrupt":
            buf = bytearray(frame)
            buf[5] ^= 0x40  # header_len high bits -> structural reject
            frame = bytes(buf)
    sock.sendall(frame)


def _read_msg(sock: socket.socket,
              max_frame_bytes: int = FED_MAX_FRAME_BYTES
              ) -> Optional[Tuple[dict, bytes]]:
    """One federation frame in. Returns ``(header, blob)`` or ``None``
    on a clean EOF.  Raises ``FrameTooLarge`` when the length header
    exceeds the bound (typed, BEFORE allocating the payload) and
    ``FederationProtocolError`` on any structural violation."""
    raw = read_exact(sock, _U32.size)
    if raw is None:
        return None
    (plen,) = _U32.unpack(raw)
    if plen > max_frame_bytes:
        raise FrameTooLarge(
            f"frame of {plen} bytes exceeds the "
            f"{max_frame_bytes}-byte bound")
    if plen < _U32.size:
        raise FederationProtocolError(
            f"frame payload of {plen} bytes cannot hold a header length")
    payload = read_exact(sock, plen)
    if payload is None:
        return None
    (hlen,) = _U32.unpack_from(payload, 0)
    if hlen > plen - _U32.size:
        raise FederationProtocolError(
            f"header length {hlen} overruns the {plen}-byte frame")
    try:
        header = json.loads(payload[_U32.size:_U32.size + hlen].decode())
    except Exception as e:
        raise FederationProtocolError(f"unreadable frame header: {e}")
    if not isinstance(header, dict) or "op" not in header:
        raise FederationProtocolError(
            "frame header must be a JSON object with an 'op'")
    return header, payload[_U32.size + hlen:]


def _json_safe(obj: Any) -> Any:
    """Recursively coerce a stats tree to plain JSON types (numpy
    scalars/arrays -> Python; unknown leaves -> ``str``)."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


# -------------------------------------------------------------- FleetHost

class _HostConn:
    """One accepted router connection: a blocking reader loop and an
    inbox-mode writer loop (completion callbacks only enqueue; sendall
    happens off every lock, broker-style)."""

    __slots__ = ("sock", "reader", "writer", "alive")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.reader: Optional[ServingLoop] = None
        self.writer: Optional[ServingLoop] = None
        self.alive = True


class _LiveReq:
    """One router-submitted request live on this host."""

    __slots__ = ("fut", "conn", "published")

    def __init__(self, fut: Future, conn: _HostConn):
        self.fut = fut
        self.conn = conn
        self.published = -1   # newest snapshot count already shipped


class FleetHost:
    """Serve one ``ReplicaFleet`` to a federation router over a framed
    localhost socket.  Usable two ways: in-process (fast tests — real
    sockets, no subprocess) and as the worker half of ``spawn_host``
    (the ``__main__`` CLI below), where a SIGKILL of the process is the
    real whole-host death the router must survive.

    Ops: ``submit`` (fleet.submit), ``adopt`` (wire-v3 snapshot bytes ->
    ``KVSnapshot.from_bytes`` -> ``fleet.adopt``; typed snapshot refusal
    travels back as an ``error`` frame), ``stats`` (JSON-safe
    ``fleet.stats()`` + metrics families), ``retire`` (migrate-out: every
    live request's newest snapshot ships to the router followed by a
    ``RequestMigrated`` error), ``drain`` (``fleet.drain``).

    A publish tick polls each live fleet future's ``_kv_snapshot``
    mirror and ships any NEWER snapshot to the router as opaque bytes —
    the crash-durable publication that makes cross-host re-adoption
    possible after this process dies without a goodbye."""

    def __init__(self, fleet: Any, *, hid: str, port: int = 0,
                 host: str = "127.0.0.1",
                 max_frame_bytes: int = FED_MAX_FRAME_BYTES,
                 publish_tick_s: float = 0.005,
                 heartbeat_path: Optional[str] = None,
                 heartbeat_interval: float = 0.05,
                 registry: Optional[MetricsRegistry] = None):
        self.fleet = fleet
        self.hid = str(hid)
        self.max_frame_bytes = int(max_frame_bytes)
        self._publish_tick_s = float(publish_tick_s)
        self._lock = threading.Lock()   # leaf: protects _conns/_live only
        self._conns: List[_HostConn] = []
        self._live: Dict[int, _LiveReq] = {}
        self._closing = False
        self.registry = registry if registry is not None else fleet.metrics

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]

        self.heartbeat: Optional[Heartbeat] = None
        if heartbeat_path:
            self.heartbeat = Heartbeat(heartbeat_path,
                                       interval=heartbeat_interval).start()

        self._accept = ServingLoop(f"fedhost-accept-{self.hid}",
                                   tick=self._accept_tick)
        supervisor().watch(self._accept,
                           on_death=lambda lp, exc: not self._closing,
                           restart=True)
        self._accept.start()
        self._publish = ServingLoop(f"fedhost-publish-{self.hid}",
                                    tick=self._publish_tick)
        supervisor().watch(self._publish,
                           on_death=lambda lp, exc: not self._closing,
                           restart=True)
        self._publish.start()

    # ----------------------------------------------------------- loops
    def _accept_tick(self) -> bool:
        try:
            sock, _ = self._srv.accept()
        except OSError:
            return False  # listening socket closed: clean exit
        with self._lock:
            closing = self._closing
        if closing:
            # close() shut the listening socket out from under a blocked
            # accept; a connection that raced through the wakeup is
            # refused, not served
            try:
                sock.close()
            except OSError:
                pass
            return False
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _HostConn(sock)
        conn.writer = ServingLoop(
            f"fedhost-writer-{self.hid}",
            handler=lambda frame, c=conn: self._write_one(c, frame))
        conn.writer.start()
        conn.reader = ServingLoop(
            f"fedhost-reader-{self.hid}",
            tick=lambda c=conn: self._reader_tick(c),
            wake=lambda c=conn: self._shut(c))
        conn.reader.start()
        with self._lock:
            # close()/kill() set _closing before they copy _conns under
            # this lock: a connection either makes their copy or sees the
            # flag here (JAX's FleetHost appends unchecked, ROADMAP C16)
            closing = self._closing
            if not closing:
                self._conns.append(conn)
        if closing:
            self._shut(conn)
            self._drop_conn(conn)
            return False
        return True

    def _write_one(self, conn: _HostConn, frame: bytes):
        try:
            conn.sock.sendall(frame)
        except OSError:
            return EXIT
        return None

    def _reader_tick(self, conn: _HostConn) -> bool:
        try:
            msg = _read_msg(conn.sock, self.max_frame_bytes)
        except (FrameTooLarge, FederationProtocolError) as e:
            # the stream offsets are untrustworthy after a bad frame:
            # answer typed, then close the connection
            self._enqueue(conn, {"op": "protocol_error", "etype":
                                 type(e).__name__, "message": str(e)})
            time.sleep(0.05)  # give the writer a beat to flush
            self._drop_conn(conn)
            return False
        except OSError:
            self._drop_conn(conn)
            return False
        if msg is None:
            self._drop_conn(conn)
            return False
        header, blob = msg
        try:
            self._handle(conn, header, blob)
        except Exception as e:   # a handler bug must not kill the link
            log.warning("fedhost %s: %s handler failed: %r",
                        self.hid, header.get("op"), e)
            self._enqueue(conn, {"op": "error", "id": header.get("id"),
                                 "etype": type(e).__name__,
                                 "message": str(e)})
        return True

    def _publish_tick(self) -> bool:
        with self._lock:
            if self._closing:
                return False
            todo = [(rid, lr, getattr(lr.fut, "_kv_snapshot", None))
                    for rid, lr in self._live.items()]
        for rid, lr, snap in todo:
            if snap is None or snap.count <= lr.published:
                continue
            lr.published = snap.count
            self._enqueue(lr.conn, {"op": "snapshot", "id": rid,
                                    "count": snap.count}, snap.to_bytes())
        time.sleep(self._publish_tick_s)
        return True

    # -------------------------------------------------------- handlers
    def _enqueue(self, conn: _HostConn, header: dict,
                 blob: bytes = b"") -> None:
        hb = json.dumps(header).encode()
        payload = _U32.pack(len(hb)) + hb + blob
        frame = _U32.pack(len(payload)) + payload
        try:
            conn.writer.put(frame)
        except Exception:
            pass  # writer already retired: the router link is gone

    def _handle(self, conn: _HostConn, header: dict, blob: bytes) -> None:
        op = header["op"]
        rid = header.get("id")
        if op == "submit":
            self._op_submit(conn, rid, header)
        elif op == "adopt":
            self._op_adopt(conn, rid, header, blob)
        elif op == "stats":
            self._enqueue(conn, {"op": "stats", "id": rid,
                                 "stats": _json_safe(self.fleet.stats()),
                                 "families": self._families()})
        elif op == "drain":
            ok = self.fleet.drain(timeout=header.get("timeout"))
            self._enqueue(conn, {"op": "ok", "id": rid, "ok": bool(ok)})
        elif op == "retire":
            n = self._migrate_out(conn) if header.get("migrate", True) else 0
            self._enqueue(conn, {"op": "ok", "id": rid, "migrated": n})
        else:
            self._enqueue(conn, {"op": "error", "id": rid,
                                 "etype": "FederationProtocolError",
                                 "message": f"unknown op {op!r}"})

    def _op_submit(self, conn: _HostConn, rid: int, header: dict) -> None:
        try:
            prompt = np.asarray(header["prompt"], dtype=np.int64)
            kwargs: Dict[str, Any] = {
                "temperature": header.get("temperature", 0.0),
                "top_k": header.get("top_k", 0),
                "seed": header.get("seed", 0),
            }
            if "eos_id" in header:
                kwargs["eos_id"] = header["eos_id"]
            fut = self.fleet.submit(prompt, header["max_tokens"],
                                    deadline_s=header.get("deadline_s"),
                                    **kwargs)
        except Exception as e:
            self._enqueue(conn, {"op": "error", "id": rid,
                                 "etype": type(e).__name__,
                                 "message": str(e)})
            return
        self._register(conn, rid, fut)

    def _op_adopt(self, conn: _HostConn, rid: int, header: dict,
                  blob: bytes) -> None:
        try:
            snap = KVSnapshot.from_bytes(blob)
            fut = self.fleet.adopt(snap,
                                   deadline_s=header.get("deadline_s"))
        except Exception as e:
            self._enqueue(conn, {"op": "error", "id": rid,
                                 "etype": type(e).__name__,
                                 "message": str(e)})
            return
        self._register(conn, rid, fut)

    def _register(self, conn: _HostConn, rid: int, fut: Future) -> None:
        lr = _LiveReq(fut, conn)
        with self._lock:
            self._live[rid] = lr
        fut.add_done_callback(
            lambda f, rid=rid: self._req_done(rid, f))

    def _req_done(self, rid: int, fut: Future) -> None:
        """Fleet future resolved: ship the outcome. Runs on whichever
        thread resolved the future — only enqueues, never blocks."""
        with self._lock:
            lr = self._live.pop(rid, None)
        if lr is None:
            return   # orphaned: migrated out or router link dropped
        if fut.cancelled():
            self._enqueue(lr.conn, {"op": "error", "id": rid,
                                    "etype": "CancelledError",
                                    "message": "request cancelled"})
            return
        exc = fut.exception()
        if exc is not None:
            hdr = {"op": "error", "id": rid, "etype": type(exc).__name__,
                   "message": str(exc)}
            snap = getattr(fut, "_kv_snapshot", None)
            blob = b""
            if snap is not None:
                hdr["snapshot_count"] = snap.count
                blob = snap.to_bytes()
            self._enqueue(lr.conn, hdr, blob)
            return
        tokens = fut.result()
        self._enqueue(lr.conn, {"op": "result", "id": rid,
                                "tokens": np.asarray(tokens).tolist()})

    def _migrate_out(self, conn: _HostConn) -> int:
        """Hand every live request back to the router: newest snapshot
        (when one was published) then a ``RequestMigrated`` error.  The
        underlying fleet attempts keep running to completion as orphaned
        compute — the fleet API has no mid-flight cancel — and their
        late results are dropped at ``_req_done``."""
        with self._lock:
            victims = list(self._live.items())
            self._live.clear()
        for rid, lr in victims:
            snap = getattr(lr.fut, "_kv_snapshot", None)
            hdr = {"op": "error", "id": rid, "etype": "RequestMigrated",
                   "message": f"host {self.hid} retiring: request "
                              f"migrated back to the router"}
            blob = b""
            if snap is not None:
                hdr["snapshot_count"] = snap.count
                blob = snap.to_bytes()
            self._enqueue(lr.conn, hdr, blob)
        return len(victims)

    def _families(self) -> list:
        regs, seen = [], set()
        for reg in (self.registry, getattr(self.fleet, "metrics", None)):
            if reg is not None and id(reg) not in seen:
                seen.add(id(reg))
                regs.append(reg)
        fams: list = []
        for reg in regs:
            fams.extend(reg._snapshot_families())
        return _json_safe(fams)

    # -------------------------------------------------------- lifecycle
    def _shut(self, conn: _HostConn) -> None:
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _drop_conn(self, conn: _HostConn) -> None:
        with self._lock:
            conn.alive = False
            if conn in self._conns:
                self._conns.remove(conn)
            orphans = [rid for rid, lr in self._live.items()
                       if lr.conn is conn]
            for rid in orphans:
                del self._live[rid]
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.writer is not None:
            try:
                conn.writer.close(timeout=1.0)
            except Exception:
                pass

    def stats(self) -> dict:
        with self._lock:
            live = len(self._live)
            conns = len(self._conns)
        return {"hid": self.hid, "port": self.port, "live": live,
                "connections": conns, "fleet": self.fleet.stats()}

    def close(self) -> None:
        """Graceful: stop serving, drop links. Does NOT close the fleet
        (the caller built it and may still drain it)."""
        with self._lock:
            self._closing = True
        if self.heartbeat is not None:
            self.heartbeat.stop()
        try:
            # shutdown() unblocks a pending accept(); close() alone
            # leaves the kernel socket accepting while the loop blocks
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            self._drop_conn(conn)
        for loop in (self._accept, self._publish):
            try:
                loop.close(timeout=2.0)
            except Exception:
                pass

    def kill(self) -> None:
        """Abrupt in-process death drill: heartbeat stops, every socket
        dies, no goodbye frames — the closest a same-process test can
        get to SIGKILL. The fleet is closed too (its futures die with
        the 'process')."""
        with self._lock:
            self._closing = True
        if self.heartbeat is not None:
            self.heartbeat.stop()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._live.clear()
        for conn in conns:
            self._shut(conn)
            try:
                conn.sock.close()
            except OSError:
                pass
        for loop in (self._accept, self._publish):
            try:
                loop.close(timeout=2.0)
            except Exception:
                pass
        try:
            self.fleet.close(timeout=10.0)
        except Exception:
            pass

    def __enter__(self) -> "FleetHost":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -------------------------------------------------------- FleetFederation

class _FedRequest:
    """One caller request, owned by the router across host deaths."""

    __slots__ = ("prompt", "max_tokens", "kwargs", "deadline", "future",
                 "resolved", "hid", "rpc_id", "attempts", "snapshot_blob",
                 "snapshot_count", "resumed", "last_error", "t_submit",
                 "t_dispatch")

    def __init__(self, prompt, max_tokens: int, kwargs: dict,
                 deadline: Optional[Deadline], future: Future):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.kwargs = kwargs
        self.deadline = deadline
        self.future = future
        self.resolved = False
        self.hid: Optional[str] = None       # host currently serving it
        self.rpc_id: Optional[int] = None
        self.attempts = 0
        self.snapshot_blob: Optional[bytes] = None  # opaque wire-v3 bytes
        self.snapshot_count = -1
        self.resumed = False     # this dispatch rode a harvested snapshot
        self.last_error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_dispatch = 0.0


class _Host:
    """Router-side record of one federated host."""

    __slots__ = ("hid", "addr", "state", "sock", "reader", "io_lock",
                 "inflight", "ewma_ms", "fail_ewma", "breaker", "retry",
                 "dispatched", "completed", "failed", "rejected",
                 "stats", "families", "suspect_reason", "warned_suspect",
                 "reconnects", "next_reconnect_at", "backoff_s",
                 "last_stats_sent", "generation")

    def __init__(self, hid: str, addr: Tuple[str, int],
                 breaker: CircuitBreaker, retry: RetryPolicy):
        self.hid = hid
        self.addr = addr
        self.state = DEAD
        self.sock: Optional[socket.socket] = None
        self.reader: Optional[ServingLoop] = None
        self.io_lock = threading.Lock()   # leaf: serializes sendall
        self.inflight = 0
        self.ewma_ms = 0.0
        self.fail_ewma = 0.0
        self.breaker = breaker
        self.retry = retry
        self.dispatched = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.stats: Optional[dict] = None      # last gossip rollup
        self.families: Optional[list] = None   # last metrics families
        self.suspect_reason: Optional[str] = None
        self.warned_suspect = False
        self.reconnects = 0
        self.next_reconnect_at = 0.0
        self.backoff_s = 0.0
        self.last_stats_sent = 0.0
        self.generation = 0   # bumps per (re)connect; stales old readers


def _score_host(h: _Host) -> float:
    """Same shape as ``ReplicaFleet._score`` one level up: pending work
    x expected latency x failure penalty."""
    return ((h.inflight + 1) * max(h.ewma_ms, 0.5)
            * (1.0 + 8.0 * h.fail_ewma))


class FleetFederation:
    """Route requests across N ``FleetHost`` endpoints; survive whole-
    host death with bit-exact cross-host snapshot adoption.

    ``hosts`` items may be ``FleetHost`` instances (in-process),
    ``HostHandle`` (spawned processes), or ``(hid, port)`` /
    ``(hid, host, port)`` tuples.  The federation owns its links and its
    ledger, NOT the host processes — killing/closing those is the
    caller's business (and the failure drill's)."""

    def __init__(self, hosts: Sequence[Any], *, max_pending: int = 256,
                 gossip_tick_s: float = 0.05,
                 stats_every_s: float = 0.25,
                 suspect_after_s: float = 0.5,
                 dead_after_s: float = 30.0,
                 heartbeat_dir: Optional[str] = None,
                 reconnect_backoff_s: float = 0.2,
                 reconnect_backoff_cap_s: float = 2.0,
                 max_redispatch: Optional[int] = None,
                 health_alpha: float = 0.25,
                 breaker_factory: Optional[Callable[[], CircuitBreaker]]
                 = None,
                 retry_factory: Optional[Callable[[], RetryPolicy]] = None,
                 max_frame_bytes: int = FED_MAX_FRAME_BYTES,
                 chaos: Any = None,
                 registry: Optional[MetricsRegistry] = None):
        if not hosts:
            raise ValueError("need at least one host")
        self._gossip_tick_s = float(gossip_tick_s)
        self._stats_every_s = float(stats_every_s)
        self._suspect_after_s = float(suspect_after_s)
        self._dead_after_s = float(dead_after_s)
        self._reconnect_backoff_s = float(reconnect_backoff_s)
        self._reconnect_backoff_cap_s = float(reconnect_backoff_cap_s)
        self._max_redispatch = (None if max_redispatch is None
                                else int(max_redispatch))
        self._alpha = float(health_alpha)
        self.max_frame_bytes = int(max_frame_bytes)
        self._chaos = chaos
        self._detector = (FailureDetector(heartbeat_dir,
                                          timeout=dead_after_s)
                          if heartbeat_dir else None)
        self.admission = AdmissionController(max_pending=max_pending)
        self._cond = threading.Condition()
        self._closing = False
        self._degraded = False
        self._hosts: Dict[str, _Host] = {}
        self._rpc: Dict[int, _FedRequest] = {}
        self._ctrl: Dict[int, dict] = {}
        self._parked: deque = deque()
        self._next_id = 0
        self._wake = threading.Event()

        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        m = self.metrics
        self._m_submitted = m.counter(
            "fed_submitted_total", "requests offered to the federation")
        self._m_rejected_submits = m.counter(
            "fed_rejected_submits_total",
            "submits shed typed before acceptance")
        self._m_completed = m.counter(
            "fed_completed_total", "requests completed")
        self._m_failed = m.counter(
            "fed_failed_total", "requests failed on error")
        self._m_expired = m.counter(
            "fed_expired_total", "requests failed on deadline")
        self._m_redispatched = m.counter(
            "fed_redispatched_total",
            "dispatch attempts re-routed to another host")
        self._m_deaths = m.counter(
            "fed_host_deaths_total", "host links declared dead")
        self._m_reconnects = m.counter(
            "fed_host_reconnects_total", "host links re-established")
        self._m_migrated = m.counter(
            "fed_migrated_total", "requests handed back by retiring hosts")
        self._m_resumes = m.counter(
            "fed_handoff_resumes_total",
            "cross-host dispatches that rode a harvested snapshot")
        self._m_fallbacks = m.counter(
            "fed_handoff_fallbacks_total",
            "snapshot adoptions refused typed; replayed from token 0")
        self._m_snapshots = m.counter(
            "fed_snapshots_total", "snapshot frames received from hosts")
        self._m_proto_errors = m.counter(
            "fed_protocol_errors_total",
            "frames rejected by structural validation (either side)")
        m.gauge("fed_hosts_ready", "hosts in READY",
                fn=lambda: self._count_state(READY))
        m.gauge("fed_hosts_suspect", "hosts in SUSPECT",
                fn=lambda: self._count_state(SUSPECT))
        m.gauge("fed_degraded_mode",
                "1 while a multi-host federation is down to <=1 READY "
                "host", fn=lambda: 1.0 if self._degraded else 0.0)
        m.gauge("fed_parked", "requests parked awaiting re-route",
                fn=lambda: self._parked_len())
        m.gauge("fed_inflight", "unresolved federated requests",
                fn=lambda: self._inflight_len())

        breaker_factory = breaker_factory or CircuitBreaker
        retry_factory = retry_factory or (lambda: RetryPolicy(
            max_attempts=2, retry_on=(TransientDispatchError,)))
        with self._cond:
            for item in hosts:
                hid, addr = self._host_endpoint(item)
                if hid in self._hosts:
                    raise ValueError(f"duplicate host id {hid!r}")
                self._hosts[hid] = _Host(hid, addr, breaker_factory(),
                                         retry_factory())
        for h in self._hosts.values():
            try:
                self._connect_host(h)
            except OSError as e:
                log.warning("federation: initial connect to %s failed "
                            "(%r); will retry", h.hid, e)
                self._schedule_reconnect(h)

        self._gossip = ServingLoop("federation-gossip",
                                   tick=self._gossip_loop,
                                   wake=self._wake.set)
        supervisor().watch(self._gossip,
                           on_death=lambda lp, exc: not self._closing,
                           restart=True)
        self._gossip.start()

    # ------------------------------------------------------- endpoints
    @staticmethod
    def _host_endpoint(item: Any) -> Tuple[str, Tuple[str, int]]:
        hid = getattr(item, "hid", None)
        port = getattr(item, "port", None)
        if hid is not None and port is not None:
            return str(hid), ("127.0.0.1", int(port))
        if isinstance(item, (tuple, list)):
            if len(item) == 2:
                return str(item[0]), ("127.0.0.1", int(item[1]))
            if len(item) == 3:
                return str(item[0]), (str(item[1]), int(item[2]))
        raise ValueError(f"cannot derive a host endpoint from {item!r}")

    def _count_state(self, state: str) -> int:
        with self._cond:
            return sum(1 for h in self._hosts.values()
                       if h.state == state)

    def _parked_len(self) -> int:
        with self._cond:
            return len(self._parked)

    def _inflight_len(self) -> int:
        with self._cond:
            return len(self._rpc) + len(self._parked)

    # ---------------------------------------------------------- links
    def _connect_host(self, h: _Host) -> None:
        """Dial the host. Raises OSError (incl. chaos conn-refused) on
        failure; on success the host is READY with a fresh reader."""
        if self._chaos is not None:
            self._chaos.net_connect_fault()
        sock = socket.create_connection(h.addr, timeout=5.0)
        if sock.getsockname() == sock.getpeername():
            # TCP simultaneous-open self-connect: retrying a freed
            # ephemeral port can land the outgoing socket on its own
            # source port, so connect() "succeeds" against a dead host.
            # Anything sent would echo straight back to the reader.
            sock.close()
            raise OSError(f"host {h.hid}: self-connect to {h.addr}, "
                          "no listener")
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._cond:
            h.sock = sock
            h.generation += 1
            h.state = READY
            h.backoff_s = 0.0
            h.suspect_reason = None
            h.warned_suspect = False
            gen = h.generation
        reader = ServingLoop(
            f"fed-link-{h.hid}-g{gen}",
            tick=lambda: self._link_tick(h, sock),
            wake=lambda s=sock: self._shut_sock(s))
        supervisor().watch(
            reader,
            on_death=lambda lp, exc, hh=h, ss=sock:
                self._reader_died(hh, ss, exc),
            restart=False)
        with self._cond:
            h.reader = reader
        reader.start()

    @staticmethod
    def _shut_sock(sock: socket.socket) -> None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _reader_died(self, h: _Host, sock: socket.socket,
                     exc: BaseException) -> bool:
        log.warning("federation: link reader for %s crashed: %r",
                    h.hid, exc)
        self._host_link_failed(h, sock, exc)
        return False   # never restart a stale link reader

    def _link_tick(self, h: _Host, sock: socket.socket) -> bool:
        try:
            msg = _read_msg(sock, self.max_frame_bytes)
        except (FrameTooLarge, FederationProtocolError) as e:
            self._m_proto_errors.inc()
            self._host_link_failed(h, sock, e)
            return False
        except OSError as e:
            self._host_link_failed(h, sock, e)
            return False
        if msg is None:
            self._host_link_failed(h, sock,
                                   OSError("host closed the link"))
            return False
        header, blob = msg
        self._on_frame(h, header, blob)
        return True

    def _send_to(self, h: _Host, header: dict, blob: bytes = b"") -> None:
        """Serialize + send on the host link (io_lock held for the
        sendall; never under ``_cond``)."""
        with h.io_lock:
            sock = h.sock
            if sock is None:
                raise OSError(f"host {h.hid}: no link")
            _send_msg(sock, header, blob, chaos=self._chaos,
                      max_frame_bytes=self.max_frame_bytes)

    # -------------------------------------------------------- routing
    def submit(self, prompt_ids, max_tokens: int, *, temperature=0.0,
               top_k=0, seed=0, eos_id=_UNSET,
               deadline_s: Optional[float] = None) -> Future:
        """Route one generation request to the healthiest host. The
        returned Future survives whole-host death (harvest + re-adopt /
        token-0 replay on a survivor) and fails only typed."""
        prompt = np.asarray(prompt_ids, dtype=np.int64)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError("prompt_ids must be a non-empty 1-D id list")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        kwargs: Dict[str, Any] = {"temperature": float(temperature),
                                  "top_k": int(top_k), "seed": int(seed)}
        if eos_id is not _UNSET:
            kwargs["eos_id"] = eos_id
        with self._cond:
            if self._closing:
                raise RuntimeError("FleetFederation is closed")
        self.admission.acquire()
        fut = Future()
        fut.add_done_callback(lambda _f: self.admission.release())
        freq = _FedRequest(
            prompt, int(max_tokens), kwargs,
            None if deadline_s is None else Deadline(deadline_s), fut)
        self._m_submitted.inc()
        routed, reason = self._route_host(freq)
        if routed:
            return fut
        if reason == "breaker":
            exc: Exception = CircuitOpen(
                "every live host's circuit breaker is open")
        elif isinstance(freq.last_error, ResilienceError):
            exc = freq.last_error
        else:
            exc = HostUnavailable(
                "no federated host can accept the request")
        self._resolve(freq, None, exc, rejected=True)
        raise exc

    def _route_host(self, freq: _FedRequest) -> Tuple[bool, str]:
        """Dispatch ``freq`` to the best host right now.  Mirrors
        ``ReplicaFleet._route_once`` one level up: health-scored
        candidates, breaker gate, typed reason when nobody takes it.
        SUSPECT hosts serve only as a last resort when no READY host
        exists.  Send failures flip the host link dead (harvesting its
        other in-flight requests) and fall through to the next
        candidate. HOT: runs per dispatch on the serving path."""
        if freq.deadline is not None and freq.deadline.expired():
            self._resolve(freq, None, DeadlineExceeded(
                "deadline expired before dispatch"))
            return True, "expired"
        tried: set = set()
        saw_breaker = False
        while True:
            with self._cond:
                if self._closing:
                    return False, "closed"
                ready = [h for h in self._hosts.values()
                         if h.state == READY and h.hid not in tried]
                if not ready:
                    ready = [h for h in self._hosts.values()
                             if h.state == SUSPECT and h.hid not in tried]
                cands = sorted(ready, key=_score_host)
                target = None
                for h in cands:
                    if not h.breaker.allow():
                        saw_breaker = True
                        continue
                    target = h
                    break
                if target is None:
                    return False, ("breaker" if saw_breaker else "nohost")
                self._next_id += 1
                rid = self._next_id
                target.inflight += 1
                target.dispatched += 1
                freq.hid = target.hid
                freq.rpc_id = rid
                freq.attempts += 1
                freq.t_dispatch = time.monotonic()
                freq.resumed = freq.snapshot_blob is not None
                self._rpc[rid] = freq
                sock_gen = target.generation
            tried.add(target.hid)
            rem = (None if freq.deadline is None
                   else freq.deadline.remaining())
            if freq.snapshot_blob is not None:
                header = {"op": "adopt", "id": rid}
                if rem is not None:
                    header["deadline_s"] = max(rem, 0.001)
                blob = freq.snapshot_blob
            else:
                header = {"op": "submit", "id": rid,
                          "prompt": freq.prompt.tolist(),
                          "max_tokens": freq.max_tokens}
                header.update(freq.kwargs)
                if rem is not None:
                    if rem <= 0:
                        with self._cond:
                            self._rpc.pop(rid, None)
                            target.inflight -= 1
                        self._resolve(freq, None, DeadlineExceeded(
                            "deadline expired before dispatch"))
                        return True, "expired"
                    header["deadline_s"] = rem
                blob = b""
            try:
                target.retry.call(self._send_to, target, header, blob,
                                  deadline=freq.deadline)
            except (OSError, FrameTooLarge) as e:
                # the whole link is suspect, not just this request:
                # _host_link_failed harvests every in-flight request on
                # it (including this one) back to parked; re-park is
                # idempotent, so just unlink ours first and move on
                with self._cond:
                    self._rpc.pop(rid, None)
                    target.inflight -= 1
                freq.hid = None
                freq.rpc_id = None
                freq.last_error = e
                with self._cond:
                    sock = target.sock
                self._host_link_failed(target, sock, e,
                                       expected_gen=sock_gen)
                continue
            if freq.resumed:
                self._m_resumes.inc()
            return True, "dispatched"

    def _resolve(self, freq: _FedRequest, value, exc, *,
                 rejected: bool = False) -> None:
        """Resolve the caller future exactly once; keep the federated
        ledger balanced (submitted == completed + failed + expired +
        rejected_submits once idle)."""
        with self._cond:
            if freq.resolved:
                return
            freq.resolved = True
            if freq.rpc_id is not None:
                self._rpc.pop(freq.rpc_id, None)
            self._cond.notify_all()
        if exc is None and rejected:
            self._m_rejected_submits.inc()
            freq.future.cancel()
            return
        if exc is not None:
            if rejected:
                self._m_rejected_submits.inc()
            elif isinstance(exc, DeadlineExceeded):
                self._m_expired.inc()
            else:
                self._m_failed.inc()
            freq.future.set_exception(exc)
        else:
            self._m_completed.inc()
            freq.future.set_result(value)

    # --------------------------------------------------------- frames
    def _on_frame(self, h: _Host, header: dict, blob: bytes) -> None:
        op = header.get("op")
        rid = header.get("id")
        if op == "result":
            self._on_result(h, rid, header)
        elif op == "error":
            self._on_error(h, rid, header, blob)
        elif op == "snapshot":
            self._on_snapshot(h, rid, header, blob)
        elif op == "stats":
            self._on_stats(h, header)
        elif op == "ok":
            self._ctrl_reply(rid, header)
        elif op == "protocol_error":
            self._m_proto_errors.inc()
            log.warning("federation: host %s rejected a frame: %s",
                        h.hid, header.get("message"))
        else:
            log.warning("federation: unknown frame op %r from %s",
                        op, h.hid)

    def _take_rpc(self, h: _Host, rid) -> Optional[_FedRequest]:
        with self._cond:
            freq = self._rpc.pop(rid, None) if rid is not None else None
            if freq is not None:
                h.inflight = max(0, h.inflight - 1)
                freq.rpc_id = None
                freq.hid = None
        return freq

    def _on_result(self, h: _Host, rid, header: dict) -> None:
        freq = self._take_rpc(h, rid)
        if freq is None:
            return   # orphan: harvested earlier, duplicate resolved
        lat_ms = (time.monotonic() - freq.t_dispatch) * 1000.0
        with self._cond:
            h.completed += 1
            a = self._alpha
            h.ewma_ms = (lat_ms if h.ewma_ms == 0.0
                         else (1 - a) * h.ewma_ms + a * lat_ms)
            h.fail_ewma = (1 - a) * h.fail_ewma
        h.breaker.record_success()
        self._resolve(freq, np.asarray(header.get("tokens", []),
                                       dtype=np.int64), None)

    def _on_error(self, h: _Host, rid, header: dict,
                  blob: bytes) -> None:
        freq = self._take_rpc(h, rid)
        if freq is None:
            return
        etype = header.get("etype", "RuntimeError")
        message = header.get("message", "")
        if blob:
            count = header.get("snapshot_count", 0)
            if count > freq.snapshot_count:
                freq.snapshot_blob = blob
                freq.snapshot_count = count
        if etype == "RequestMigrated":
            self._m_migrated.inc()
            self._park(freq)
            return
        if etype in ("SnapshotInvalid", "SnapshotUnsupported",
                     "SnapshotError", "SnapshotUnavailable"):
            # the surviving host refused the harvested snapshot typed
            # (checksum, geometry, version): drop it and replay from
            # token 0 — bit-exact via the fold_in key schedule
            freq.snapshot_blob = None
            freq.snapshot_count = -1
            self._m_fallbacks.inc()
            self._park(freq)
            return
        if etype == "DeadlineExceeded":
            self._resolve(freq, None, DeadlineExceeded(message))
            return
        if etype == "ValueError":
            self._resolve(freq, None, ValueError(message))
            return
        if etype in _SHED_ERRORS:
            with self._cond:
                h.rejected += 1
            h.breaker.record_failure()
            freq.last_error = _WIRE_ERRORS.get(
                etype, ResilienceError)(message)
            self._park(freq)
            return
        # hard failure on that host (replica died past the fleet's own
        # budget, handler bug, cancelled): blame the host, try another
        with self._cond:
            h.failed += 1
            a = self._alpha
            h.fail_ewma = (1 - a) * h.fail_ewma + a
        h.breaker.record_failure()
        freq.last_error = _WIRE_ERRORS.get(
            etype, ResilienceError)(f"{etype} on host {h.hid}: {message}")
        self._park(freq)

    def _on_snapshot(self, h: _Host, rid, header: dict,
                     blob: bytes) -> None:
        try:
            # header-only structural check (opaque payload untouched):
            # a mangled blob is dropped here, never offered for adoption
            peek_snapshot(blob)
        except SnapshotError:
            self._m_proto_errors.inc()
            return
        self._m_snapshots.inc()
        with self._cond:
            freq = self._rpc.get(rid)
            if freq is None:
                return
            count = header.get("count", 0)
            if count > freq.snapshot_count:
                freq.snapshot_blob = blob
                freq.snapshot_count = count

    def _on_stats(self, h: _Host, header: dict) -> None:
        with self._cond:
            h.stats = header.get("stats")
            h.families = header.get("families")
            if h.state == SUSPECT and h.suspect_reason == "stats":
                h.state = READY
                h.suspect_reason = None
                h.warned_suspect = False
                log.warning("federation: host %s recovered (gossip "
                            "stats reply)", h.hid)
            self._note_degraded_locked()
        self._ctrl_reply(header.get("id"), header)

    def _ctrl_reply(self, rid, header: dict) -> None:
        if rid is None:
            return
        with self._cond:
            slot = self._ctrl.get(rid)
            if slot is None:
                return
            slot["reply"] = header
        slot["evt"].set()

    # ------------------------------------------------- death + harvest
    def _host_link_failed(self, h: _Host, sock, exc,
                          expected_gen: Optional[int] = None) -> None:
        """The link to ``h`` is gone (TCP error, EOF, poisoned stream,
        or a heartbeat dead-verdict): mark the host DEAD, harvest every
        in-flight request it held — each with its newest published
        snapshot already attached — and park them for re-route. HOT:
        this is the crash path the whole federation exists for."""
        with self._cond:
            if sock is not None and h.sock is not sock:
                return   # stale reader of a replaced link
            if expected_gen is not None and h.generation != expected_gen:
                return
            if h.state in (DEAD, RETIRED):
                return
            h.state = DEAD
            old_sock = h.sock
            h.sock = None
            victims = self._harvest_host(h)
            self._note_degraded_locked()
        self._m_deaths.inc()
        log.warning("federation: host %s is DEAD (%r); harvested %d "
                    "in-flight request(s)", h.hid, exc, len(victims))
        if old_sock is not None:
            try:
                old_sock.close()
            except OSError:
                pass
        for freq in victims:
            self._m_redispatched.inc()
        self._schedule_reconnect(h)
        self._wake.set()

    def _harvest_host(self, h: _Host) -> List[_FedRequest]:
        """Collect every in-flight request owned by ``h`` off the rpc
        table and park it (``_cond`` held).  Snapshots harvested from
        the host's periodic publications ride along on each request, so
        the re-route adopts at position N instead of replaying. HOT."""
        victims = [freq for freq in self._rpc.values() if freq.hid == h.hid]
        for freq in victims:
            self._rpc.pop(freq.rpc_id, None)
            freq.rpc_id = None
            freq.hid = None
            self._parked.append(freq)
        h.inflight = 0
        return victims

    def _park(self, freq: _FedRequest) -> None:
        if (self._max_redispatch is not None
                and freq.attempts > self._max_redispatch):
            exc = freq.last_error or HostUnavailable(
                "redispatch budget exhausted")
            self._resolve(freq, None, exc)
            return
        if freq.deadline is not None and freq.deadline.expired():
            self._resolve(freq, None, DeadlineExceeded(
                f"deadline expired after {freq.attempts} attempt(s)"))
            return
        with self._cond:
            self._parked.append(freq)
        self._m_redispatched.inc()
        self._wake.set()

    def _schedule_reconnect(self, h: _Host) -> None:
        with self._cond:
            h.backoff_s = (self._reconnect_backoff_s if h.backoff_s == 0.0
                           else min(h.backoff_s * 2.0,
                                    self._reconnect_backoff_cap_s))
            h.next_reconnect_at = time.monotonic() + h.backoff_s

    # --------------------------------------------------------- gossip
    def _gossip_loop(self) -> bool:
        """One supervised router tick: heartbeat suspect/dead verdicts,
        periodic stats gossip, dead-host reconnect, degraded-mode eval,
        and parked-request service.  Paced by ``_wake`` so a harvest or
        park is serviced immediately instead of next tick. HOT: every
        recovery decision the federation makes happens here."""
        self._wake.wait(self._gossip_tick_s)
        self._wake.clear()
        with self._cond:
            if self._closing:
                return False
        now = time.monotonic()

        # 1) heartbeat gossip: SUSPECT on missed beats BEFORE any TCP
        #    error; DEAD on the long verdict
        if self._detector is not None:
            suspects = set(self._detector.dead_workers(
                timeout=self._suspect_after_s))
            deads = set(self._detector.dead_workers(
                timeout=self._dead_after_s))
            for h in self._live_hosts():
                if h.hid in deads:
                    with self._cond:
                        sock = h.sock
                    self._host_link_failed(
                        h, sock, OSError("heartbeat dead verdict"))
                elif h.hid in suspects:
                    self._mark_suspect(h, "heartbeat")
                else:
                    with self._cond:
                        if (h.state == SUSPECT
                                and h.suspect_reason == "heartbeat"):
                            h.state = READY
                            h.suspect_reason = None
                            h.warned_suspect = False
                            log.warning("federation: host %s recovered "
                                        "(heartbeat fresh)", h.hid)
                            self._note_degraded_locked()

        # 2) stats gossip rollups
        for h in self._live_hosts():
            if now - h.last_stats_sent < self._stats_every_s:
                continue
            h.last_stats_sent = now
            with self._cond:
                self._next_id += 1
                rid = self._next_id
            try:
                self._send_to(h, {"op": "stats", "id": rid})
            except OSError:
                self._mark_suspect(h, "stats")

        # 3) reconnect DEAD hosts past backoff (partition heal;
        #    a SIGKILLed process keeps refusing -> stays DEAD)
        for h in self._dead_hosts():
            if now < h.next_reconnect_at:
                continue
            try:
                self._connect_host(h)
            except OSError:
                self._schedule_reconnect(h)
                continue
            with self._cond:
                h.reconnects += 1
                self._note_degraded_locked()
            self._m_reconnects.inc()
            log.warning("federation: host %s reconnected", h.hid)

        # 4) serve parked requests
        self._service_parked_fed()
        return True

    def _live_hosts(self) -> List[_Host]:
        with self._cond:
            return [h for h in self._hosts.values()
                    if h.state in (READY, SUSPECT)]

    def _dead_hosts(self) -> List[_Host]:
        with self._cond:
            return [h for h in self._hosts.values() if h.state == DEAD]

    def _mark_suspect(self, h: _Host, reason: str) -> None:
        with self._cond:
            if h.state != READY:
                return
            h.state = SUSPECT
            h.suspect_reason = reason
            warn = not h.warned_suspect
            h.warned_suspect = True
            self._note_degraded_locked()
        if warn:
            log.warning("federation: host %s SUSPECT (%s) — routing "
                        "around it before any TCP error surfaces",
                        h.hid, reason)

    def _note_degraded_locked(self) -> None:
        """Degraded-mode flip (``_cond`` held): a multi-host federation
        down to <=1 READY host serves degraded, mirroring the fleet's
        decode-tier-dark transition — typed log once per flip, gauge
        auto-clears on host recovery."""
        if len(self._hosts) <= 1:
            return
        ready = sum(1 for h in self._hosts.values() if h.state == READY)
        dark = ready <= 1
        if dark == self._degraded:
            return
        self._degraded = dark
        if dark:
            log.warning(
                "federation degraded mode ENTERED: %d/%d hosts READY; "
                "serving on the survivor(s)", ready, len(self._hosts))
        else:
            log.warning("federation degraded mode cleared: %d/%d hosts "
                        "READY", ready, len(self._hosts))

    def _service_parked_fed(self) -> None:
        """Re-route every parked request once; requests that still find
        no host stay parked (zero lost futures — they fail only on
        deadline, redispatch budget, or close)."""
        while True:
            with self._cond:
                if not self._parked:
                    return
                freq = self._parked.popleft()
            if freq.resolved:
                continue
            if freq.deadline is not None and freq.deadline.expired():
                self._resolve(freq, None, DeadlineExceeded(
                    f"deadline expired after {freq.attempts} attempt(s)"))
                continue
            routed, reason = self._route_host(freq)
            if not routed:
                with self._cond:
                    self._parked.appendleft(freq)
                return

    # ------------------------------------------------------- control
    def _control(self, h: _Host, header: dict,
                 timeout: float = 10.0) -> Optional[dict]:
        with self._cond:
            self._next_id += 1
            rid = self._next_id
            slot = {"evt": threading.Event(), "reply": None}
            self._ctrl[rid] = slot
        header = dict(header)
        header["id"] = rid
        try:
            self._send_to(h, header)
            if not slot["evt"].wait(timeout):
                return None
            return slot["reply"]
        finally:
            with self._cond:
                self._ctrl.pop(rid, None)

    def retire_host(self, hid: str, *, migrate: bool = True,
                    timeout: float = 10.0) -> bool:
        """Deliberately remove a host: no new routing, then ask it to
        hand back its in-flight work (each request returns as a
        ``RequestMigrated`` error with its newest snapshot and resumes
        on a surviving host)."""
        with self._cond:
            h = self._hosts.get(hid)
            if h is None:
                raise KeyError(f"unknown host {hid!r}")
            prev = h.state
            h.state = RETIRED
            self._note_degraded_locked()
        if prev == DEAD or h.sock is None:
            return True
        reply = self._control(h, {"op": "retire", "migrate": migrate},
                              timeout=timeout)
        return reply is not None

    def host_stats(self, hid: str, *,
                   timeout: float = 10.0) -> Optional[dict]:
        """Fresh stats RPC to one host (gossip keeps a cached rollup;
        this forces a round trip)."""
        with self._cond:
            h = self._hosts.get(hid)
        if h is None:
            raise KeyError(f"unknown host {hid!r}")
        reply = self._control(h, {"op": "stats"}, timeout=timeout)
        return None if reply is None else reply.get("stats")

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every accepted request has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._rpc or self._parked:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(rem if rem is not None else 0.5)
        return True

    # --------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._cond:
            hosts = list(self._hosts.values())
            per = []
            for h in hosts:
                per.append({
                    "hid": h.hid,
                    "state": h.state,
                    "score": _score_host(h),
                    "ewma_latency_ms": h.ewma_ms,
                    "failure_ewma": h.fail_ewma,
                    "inflight": h.inflight,
                    "dispatched": h.dispatched,
                    "completed": h.completed,
                    "failed": h.failed,
                    "rejected": h.rejected,
                    "reconnects": h.reconnects,
                    "suspect_reason": h.suspect_reason,
                    "stats": h.stats,
                })
            ready = sum(1 for h in hosts if h.state == READY)
            suspect = sum(1 for h in hosts if h.state == SUSPECT)
            parked = len(self._parked)
            inflight = len(self._rpc)
            degraded = self._degraded
        for blk, h in zip(per, hosts):
            blk["breaker"] = h.breaker.state
        out = {
            "federation": {
                "hosts": len(hosts),
                "ready": ready,
                "suspect": suspect,
                "deaths": int(self._m_deaths.value),
                "reconnects": int(self._m_reconnects.value),
                "submitted": int(self._m_submitted.value),
                "rejected_submits": int(self._m_rejected_submits.value),
                "completed": int(self._m_completed.value),
                "failed": int(self._m_failed.value),
                "expired": int(self._m_expired.value),
                "redispatched": int(self._m_redispatched.value),
                "migrated": int(self._m_migrated.value),
                "handoff_resumes": int(self._m_resumes.value),
                "handoff_fallbacks": int(self._m_fallbacks.value),
                "snapshots": int(self._m_snapshots.value),
                "parked": parked,
                "inflight": inflight,
                "degraded_mode": degraded,
            },
            "hosts": per,
            "admission": {"pending": self.admission.pending,
                          "accepted": self.admission.accepted,
                          "rejected": self.admission.rejected},
        }
        return out

    def metrics_sources(self) -> List[Tuple[dict, Any]]:
        """Sources for ``metrics.exposition.render_text``: the router's
        own registry plus each host's last gossiped families under an
        injected ``host=`` label — one scrape shows the whole fleet
        of fleets."""
        out: List[Tuple[dict, Any]] = [({}, self.metrics)]
        with self._cond:
            for h in self._hosts.values():
                if h.families:
                    out.append(({"host": h.hid}, h.families))
        return out

    # ------------------------------------------------------ lifecycle
    def close(self, timeout: float = 10.0) -> None:
        """Shut the router down: leftover requests fail typed (zero
        lost futures), links drop, loops retire. Host processes /
        in-process FleetHosts are NOT closed — the federation never
        owned them."""
        with self._cond:
            if self._closing:
                return
            self._closing = True
            leftovers = list(self._rpc.values()) + list(self._parked)
            self._rpc.clear()
            self._parked.clear()
            hosts = list(self._hosts.values())
        self._wake.set()
        for freq in leftovers:
            self._resolve(freq, None, HostUnavailable(
                "federation closed with the request unresolved"))
        for h in hosts:
            with self._cond:
                sock, reader = h.sock, h.reader
                h.sock = None
                h.state = RETIRED
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            if reader is not None:
                try:
                    reader.close(timeout=2.0)
                except Exception:
                    pass
        try:
            self._gossip.close(timeout=timeout)
        except Exception:
            pass

    def __enter__(self) -> "FleetFederation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------- host processes

class HostHandle:
    """One spawned fleet-host process."""

    __slots__ = ("hid", "port", "pid", "proc", "heartbeat_path")

    def __init__(self, hid: str, port: int, pid: int,
                 proc: subprocess.Popen,
                 heartbeat_path: Optional[str] = None):
        self.hid = hid
        self.port = port
        self.pid = pid
        self.proc = proc
        self.heartbeat_path = heartbeat_path

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the whole-process death the federation must
        survive. No flush, no goodbye: the kernel resets the sockets
        and the heartbeat file goes stale where it stands."""
        self.proc.kill()
        self.proc.wait(timeout=30)

    def terminate(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)


def build_generation_fleet(*, vocab: int = 17, max_length: int = 16,
                           d_model: int = 16, n_heads: int = 2,
                           n_blocks: int = 1, net_seed: int = 3,
                           replicas: int = 2, slots: int = 4,
                           page_size: int = 16, snapshot_every: int = 0,
                           steps_per_dispatch: int = 4,
                           max_pending: int = 64,
                           fleet_max_pending: int = 256,
                           chaos: Optional[dict] = None,
                           chaos_seed_base: int = 1000,
                           device=None) -> ReplicaFleet:
    """Default fleet builder for spawned host processes: a TransformerLM
    served by ``replicas`` GenerationServers on ``device`` (CUDA unless
    the caller names another). ``chaos`` (ChaosPolicy keyword arguments)
    seeds each replica's own injector off ``chaos_seed_base + rid``; it is
    JSON, so it travels in the spawn spec. The weights come from the
    port's initialisers under ``net_seed``, which draw from a torch
    generator: a host that must match another package's weights names a
    builder of its own in the spec."""
    from deeplearning4j_torch import resolve_device
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.parallel.generation import GenerationServer

    dev = resolve_device(device)
    lm = TransformerLM(num_labels=vocab, max_length=max_length,
                       d_model=d_model, n_heads=n_heads,
                       n_blocks=n_blocks, seed=net_seed).init(device=dev)

    def factory(rid: int):
        cp = (ChaosPolicy(seed=chaos_seed_base + rid, **chaos)
              if chaos else None)
        return GenerationServer(lm, vocab, slots=slots,
                                page_size=page_size,
                                snapshot_every=snapshot_every,
                                steps_per_dispatch=steps_per_dispatch,
                                max_pending=max_pending, chaos=cp,
                                device=dev)

    return ReplicaFleet(factory, replicas=replicas,
                        max_pending=fleet_max_pending)


def spawn_host(spec: dict, *, timeout: float = 180.0,
               env: Optional[dict] = None, device=None) -> HostHandle:
    """Launch one fleet-host process (``python -m deeplearning4j_torch.
    parallel.federation --spec ...``) and wait for its READY line.

    ``spec`` keys: ``hid`` (required), ``port`` (default 0 = ephemeral),
    ``heartbeat_dir``, ``heartbeat_interval``, ``builder``
    (``"module:attr"``, default ``build_generation_fleet``),
    ``builder_kwargs``, ``max_frame_bytes``, ``publish_tick_s``, and
    ``device``: the device the builder gets (``device=`` here sets it).
    With no device the host serves on the card, and a host without one
    exits before READY; the CPU serves only when asked for. A builder
    that fails (no card, a kernel that does not load) surfaces here with
    the child's output."""
    if device is not None:
        spec = dict(spec, device=str(device))
    cmd = [sys.executable, "-m", "deeplearning4j_torch.parallel.federation",
           "--spec", json.dumps(spec)]
    full_env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    prev = full_env.get("PYTHONPATH", "")
    full_env["PYTHONPATH"] = (repo_root + os.pathsep + prev
                              if prev else repo_root)
    if env:
        full_env.update(env)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=full_env,
                            text=True, bufsize=1)
    deadline = time.monotonic() + timeout
    lines: List[str] = []
    ready: Optional[dict] = None
    while True:
        rem = deadline - time.monotonic()
        if rem <= 0:
            proc.kill()
            proc.wait(timeout=30)
            raise RuntimeError(
                f"fleet host {spec.get('hid')!r} did not become READY "
                f"within {timeout}s; output so far:\n" + "".join(lines))
        r, _, _ = select.select([proc.stdout], [], [], min(rem, 0.5))
        if not r:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"fleet host {spec.get('hid')!r} exited rc="
                    f"{proc.returncode} before READY; output:\n"
                    + "".join(lines))
            continue
        line = proc.stdout.readline()
        if line == "":
            proc.wait(timeout=30)
            raise RuntimeError(
                f"fleet host {spec.get('hid')!r} closed stdout before "
                f"READY (rc={proc.returncode}); output:\n"
                + "".join(lines))
        lines.append(line)
        if line.startswith("FLEETHOST READY "):
            fields = dict(kv.split("=", 1)
                          for kv in line.split()[2:])
            ready = {"hid": fields["hid"], "port": int(fields["port"]),
                     "pid": int(fields["pid"])}
            break

    def _drain():
        try:
            for _ in proc.stdout:
                pass
        except Exception:
            pass

    threading.Thread(target=_drain, daemon=True,
                     name=f"fedhost-stdout-{ready['hid']}").start()
    hb_path = None
    if spec.get("heartbeat_dir"):
        hb_path = os.path.join(spec["heartbeat_dir"],
                               f"{spec['hid']}.heartbeat")
    return HostHandle(ready["hid"], ready["port"], ready["pid"], proc,
                      heartbeat_path=hb_path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Worker-process entry point: build the fleet named by the spec on
    the spec's device, serve it as a FleetHost, print the READY line, and
    block until killed."""
    ap = argparse.ArgumentParser(
        description="serve one ReplicaFleet as a federation host")
    ap.add_argument("--spec", required=True,
                    help="JSON spec: hid/port/heartbeat_dir/builder/device/"
                         "...")
    args = ap.parse_args(argv)
    spec = json.loads(args.spec)
    from deeplearning4j_torch import resolve_device

    # no device in the spec means the card: resolve_device raises here,
    # before READY, on a host without one
    dev = resolve_device(spec.get("device"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the host spec names {spec.get('device')!r} and no CUDA "
            "device is available; this host will not serve on the CPU")
    builder = spec.get(
        "builder",
        "deeplearning4j_torch.parallel.federation:build_generation_fleet")
    mod_name, _, attr = builder.partition(":")
    builder_fn = getattr(importlib.import_module(mod_name), attr)
    fleet = builder_fn(device=dev, **spec.get("builder_kwargs", {}))
    hb_path = None
    if spec.get("heartbeat_dir"):
        os.makedirs(spec["heartbeat_dir"], exist_ok=True)
        hb_path = os.path.join(spec["heartbeat_dir"],
                               f"{spec['hid']}.heartbeat")
    host = FleetHost(
        fleet, hid=spec["hid"], port=spec.get("port", 0),
        heartbeat_path=hb_path,
        heartbeat_interval=spec.get("heartbeat_interval", 0.05),
        max_frame_bytes=spec.get("max_frame_bytes", FED_MAX_FRAME_BYTES),
        publish_tick_s=spec.get("publish_tick_s", 0.005))
    print(f"FLEETHOST READY hid={host.hid} port={host.port} "
          f"pid={os.getpid()}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    host.close()
    fleet.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
