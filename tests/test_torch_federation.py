"""The port's fleet federation (``deeplearning4j_torch/parallel/
federation.py``) on the CPU: the counterpart of every test in
``tests/test_federation.py``, with the JAX module as the reference.

- Frames are byte for byte JAX's ``_send_msg`` output, and each package's
  ``_read_msg`` reads the other's.
- The network fault sequences of the port's ``ChaosPolicy`` are JAX's
  draws for the same seeds.
- Every federated stream equals JAX's ``greedy_generate`` /
  ``sample_generate`` on the JAX test model (d_model 16), whose weights
  reach the port's hosts through ``params_from_jax``: in process through
  ``jax_weight_fleet`` below, and in spawned hosts through the spec's
  ``builder`` key naming it (it imports nothing of JAX, and the child
  reports that it never loaded JAX).

In-process port hosts cost no compile, so routing, gossip, heal, degraded
mode, drain-migrate, metrics and an in-process kill drill run in tier-1;
the SIGKILL drill over two ``spawn_host(..., device="cpu")`` processes and
the interop tests with JAX's ``FleetHost``/``FleetFederation`` are
``slow`` (``-m federation`` runs them all). JAX's references are computed
once per stream and cached.
"""

import ast
import json
import os
import socket
import struct
import sys
import time
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.metrics.exposition import render_text  # noqa: E402
from deeplearning4j_torch.metrics.registry import (  # noqa: E402
    MetricsRegistry)
from deeplearning4j_torch.parallel import federation as fed_mod  # noqa: E402
from deeplearning4j_torch.parallel.elastic import Heartbeat  # noqa: E402
from deeplearning4j_torch.parallel.federation import (  # noqa: E402
    READY, SUSPECT, FederationProtocolError, FleetFederation, FleetHost,
    HostUnavailable, _json_safe, _read_msg, _send_msg, spawn_host)
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    ChaosPolicy, ResilienceError, TransientDispatchError)
from deeplearning4j_torch.streaming.broker import (  # noqa: E402
    FrameTooLarge, read_frame)

pytestmark = [pytest.mark.torch_port, pytest.mark.federation]

V = 17
#: the JAX test model's geometry (``tests/test_federation.py::lm``)
LM = dict(num_labels=V, max_length=32, d_model=16, n_heads=2, n_blocks=1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the builder a spawned host names (the child imports this file from the
#: repository root)
BUILDER = "tests.test_torch_federation:jax_weight_fleet"
#: the same function as this process imported it, for ``main`` in process
HERE = f"{__name__}:jax_weight_fleet"


# ---------------------------------------------------------------- builder
def _save_weights(path, params):
    """One npz entry a leaf, ``vertex|name``; a vertex without weights
    keeps an empty ``vertex|`` entry."""
    entries = {}
    for k, p in params.items():
        entries[f"{k}|"] = np.zeros(0, np.float32)
        entries.update({f"{k}|{n}": np.asarray(v) for n, v in p.items()})
    np.savez(path, **entries)


def _load_weights(path):
    params = {}
    with np.load(path) as z:
        for key in z.files:
            vertex, name = key.split("|")
            leaves = params.setdefault(vertex, {})
            if name:
                leaves[name] = z[key]
    return params


def jax_weight_fleet(*, weights, device, replicas=1, slots=4,
                     page_size=16, snapshot_every=0, steps_per_dispatch=4,
                     max_pending=64, fleet_max_pending=256, chaos=None,
                     chaos_seed_base=1000, report=None):
    """``build_generation_fleet`` of the JAX test model, on the weights a
    JAX net wrote to ``weights`` (npz, carried in through
    ``params_from_jax``). A spawned host names it in its spec; ``report``
    gets the child's pid and whether JAX was ever imported there."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.parallel.fleet import ReplicaFleet
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.utils.convert import params_from_jax

    torch.set_num_threads(1)
    lm = TransformerLM(**LM).init(device=device)
    params_from_jax(_load_weights(weights), lm)

    def factory(rid):
        cp = (ChaosPolicy(seed=chaos_seed_base + rid, **chaos)
              if chaos else None)
        return GenerationServer(lm, V, slots=slots, page_size=page_size,
                                snapshot_every=snapshot_every,
                                steps_per_dispatch=steps_per_dispatch,
                                max_pending=max_pending, chaos=cp,
                                device=device)

    if report:
        with open(report, "w") as fh:
            json.dump({"pid": os.getpid(), "jax": "jax" in sys.modules,
                       "dl4j_tpu": "deeplearning4j_tpu" in sys.modules,
                       "device": str(device)}, fh)
    return ReplicaFleet(factory, replicas=replicas,
                        max_pending=fleet_max_pending)


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jlm():
    """The JAX test model (``tests/test_federation.py::lm``)."""
    from deeplearning4j_tpu.models.zoo import TransformerLM as JLM
    return JLM(**LM, seed=3).init()


@pytest.fixture(scope="module")
def weights(jlm, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fed_weights") / "lm.npz")
    _save_weights(path, {k: {n: np.asarray(v) for n, v in p.items()}
                         for k, p in jlm.params.items()})
    return path


_REFS: dict = {}


def _serial_refs(jlm, specs):
    """JAX's streams for ``specs``, one ``greedy_generate`` /
    ``sample_generate`` each, cached across the module."""
    from deeplearning4j_tpu.models.zoo import greedy_generate, sample_generate

    refs = []
    for p, steps, temp, top_k, seed in specs:
        key = (tuple(int(t) for t in p), steps, temp, top_k, seed)
        if key not in _REFS:
            if temp == 0.0:
                out = greedy_generate(jlm, p[None], steps, V)[0]
            else:
                out = sample_generate(jlm, p[None], steps, V,
                                      temperature=temp, top_k=top_k,
                                      seed=seed)[0]
            _REFS[key] = np.asarray(out, dtype=np.int64)
        refs.append(_REFS[key])
    return refs


def _mixed_specs(n, rng, steps=6):
    shapes = [(3, steps), (5, steps - 1), (4, steps + 1)]
    specs = []
    for i in range(n):
        plen, st = shapes[i % len(shapes)]
        p = rng.integers(1, V, size=plen).astype(np.int64)
        if i % 2 == 0:
            specs.append((p, st, 0.0, 0, 0))
        else:
            specs.append((p, st, 0.9, 5, 2000 + i))
    return specs


def _submit_all(fed, specs, deadline_s=240.0):
    futs = []
    for p, steps, temp, top_k, seed in specs:
        while True:
            try:
                futs.append(fed.submit(p, steps, temperature=temp,
                                       top_k=top_k, seed=seed,
                                       deadline_s=deadline_s))
                break
            except ResilienceError:
                time.sleep(0.02)
    return futs


def _assert_streams(futs, refs):
    for fut, ref in zip(futs, refs):
        got = np.asarray(fut.result(timeout=240), dtype=np.int64)
        assert np.array_equal(got, ref), (got, ref)


def _assert_ledger(fed):
    st = fed.stats()["federation"]
    assert st["submitted"] == (st["completed"] + st["failed"]
                               + st["expired"] + st["rejected_submits"]), st
    assert st["inflight"] == 0 and st["parked"] == 0, st
    return st


@contextmanager
def host_pair(weights, hb_dir=None, hids=("h0", "h1"), **fleet_kw):
    """Two in-process port FleetHosts over their own one-replica fleets
    on the CPU: real localhost sockets, no subprocess."""
    fleets, hosts = [], []
    try:
        for hid in hids:
            fl = jax_weight_fleet(weights=weights, device="cpu", **fleet_kw)
            fleets.append(fl)
            hb = os.path.join(hb_dir, f"{hid}.heartbeat") if hb_dir else None
            hosts.append(FleetHost(fl, hid=hid, heartbeat_path=hb,
                                   heartbeat_interval=0.05))
        yield hosts
    finally:
        for h in hosts:
            h.close()
        for fl in fleets:
            fl.close()


def _wait(pred, timeout=60.0, tick=0.02, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(tick)
    raise AssertionError(f"timed out waiting for {msg}")


def _per_host(fed):
    return {b["hid"]: b for b in fed.stats()["hosts"]}


def _victim_has_snapshot(fed, hid):
    """The router holds a published snapshot of a request in flight on
    ``hid``: a kill now must re-adopt it."""
    with fed._cond:
        return any(fq.hid == hid and fq.snapshot_blob is not None
                   for fq in fed._rpc.values())


# ---------------------------------------------------------------- routing
class TestFederationRouting:
    def test_routing_bit_exact_and_balanced(self, jlm, weights):
        """Mixed greedy and sampled traffic over two hosts: every
        completion equals JAX's stream, both hosts take load, the ledger
        balances; the stats block has JAX's keys in JAX's order, and the
        synchronous validation errors are JAX's."""
        specs = _mixed_specs(10, np.random.default_rng(0))
        refs = _serial_refs(jlm, specs)
        with host_pair(weights) as hosts, FleetFederation(hosts) as fed:
            st = fed.stats()
            assert list(st["federation"].keys()) == [
                "hosts", "ready", "suspect", "deaths", "reconnects",
                "submitted", "rejected_submits", "completed",
                "failed", "expired", "redispatched", "migrated",
                "handoff_resumes", "handoff_fallbacks", "snapshots",
                "parked", "inflight", "degraded_mode"]
            assert st["federation"]["hosts"] == 2
            assert st["federation"]["ready"] == 2
            assert {b["hid"] for b in st["hosts"]} == {"h0", "h1"}
            assert {b["state"] for b in st["hosts"]} == {READY}
            with pytest.raises(ValueError):
                fed.submit(np.array([[1, 2]]), 4)   # 2-D prompt
            with pytest.raises(ValueError):
                fed.submit(np.array([1, 2]), 4, deadline_s=-1.0)
            _assert_streams(_submit_all(fed, specs), refs)
            st = _assert_ledger(fed)
            assert st["completed"] == 10
            per = _per_host(fed)
            assert per["h0"]["dispatched"] > 0
            assert per["h1"]["dispatched"] > 0

    def test_submit_sheds_typed_when_no_host(self):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        dead_port = probe.getsockname()[1]
        probe.close()
        fed = FleetFederation([("h0", dead_port)], reconnect_backoff_s=10.0)
        try:
            with pytest.raises(HostUnavailable):
                fed.submit(np.array([1, 2, 3]), 4)
            assert fed.stats()["federation"]["rejected_submits"] == 1
            _assert_ledger(fed)
        finally:
            fed.close()


# ----------------------------------------------------------------- gossip
class TestFederationGossip:
    def test_heartbeat_suspect_before_tcp_error(self, tmp_path, jlm,
                                                weights):
        """A host whose heartbeat goes stale (sockets open, no TCP error)
        is marked SUSPECT and routed around; fresh beats clear it."""
        hb = str(tmp_path)
        with host_pair(weights, hb_dir=hb) as hosts:
            h1 = hosts[1]
            with FleetFederation(hosts, heartbeat_dir=hb,
                                 suspect_after_s=0.3, dead_after_s=600.0,
                                 gossip_tick_s=0.03) as fed:
                _wait(lambda: fed.stats()["federation"]["ready"] == 2,
                      msg="both hosts READY")
                h1.heartbeat.stop()   # the wedge: beats stop, sockets live
                _wait(lambda: fed.stats()["federation"]["suspect"] == 1,
                      msg="h1 SUSPECT on missed beats")
                st = fed.stats()
                assert st["federation"]["deaths"] == 0
                per = {b["hid"]: b for b in st["hosts"]}
                assert per["h1"]["state"] == SUSPECT
                assert per["h1"]["suspect_reason"] == "heartbeat"
                before = per["h1"]["dispatched"]
                specs = _mixed_specs(2, np.random.default_rng(1))
                _assert_streams(_submit_all(fed, specs),
                                _serial_refs(jlm, specs))
                per = _per_host(fed)
                assert per["h1"]["dispatched"] == before
                assert per["h0"]["dispatched"] >= 2
                h1.heartbeat = Heartbeat(h1.heartbeat.path,
                                         interval=0.05).start()
                _wait(lambda: fed.stats()["federation"]["suspect"] == 0,
                      msg="h1 recovered on fresh beats")
                assert fed.stats()["federation"]["deaths"] == 0
                _assert_ledger(fed)

    def test_host_down_heal_and_degraded_mode(self, jlm, weights):
        """An in-process host death: degraded mode (gauge and one log a
        flip), everything served on the survivor, then a replacement host
        on the same endpoint heals the link and clears it."""
        fl_new = h_new = None
        with host_pair(weights) as hosts:
            h1 = hosts[1]
            with FleetFederation(hosts, reconnect_backoff_s=0.05,
                                 gossip_tick_s=0.03) as fed:
                try:
                    port1 = h1.port
                    h1.kill()
                    _wait(lambda: fed.stats()["federation"]["degraded_mode"],
                          msg="degraded mode entered")
                    gauge = {g["name"]: g for g in
                             fed.metrics._snapshot_families()}
                    assert gauge["fed_degraded_mode"]["samples"][0][1] == 1.0
                    specs = _mixed_specs(2, np.random.default_rng(2))
                    _assert_streams(_submit_all(fed, specs),
                                    _serial_refs(jlm, specs))
                    assert _per_host(fed)["h0"]["completed"] >= 2
                    fl_new = jax_weight_fleet(weights=weights, device="cpu")
                    h_new = FleetHost(fl_new, hid="h1", port=port1)
                    _wait(lambda: not
                          fed.stats()["federation"]["degraded_mode"],
                          msg="degraded mode cleared on heal")
                    st = fed.stats()["federation"]
                    assert st["reconnects"] >= 1 and st["deaths"] >= 1
                    _assert_ledger(fed)
                finally:
                    if h_new is not None:
                        h_new.close()
                    if fl_new is not None:
                        fl_new.close()

    def test_kill_right_after_connect_drops_every_link(self):
        """ROADMAP C16: a host killed while it is still setting up a
        freshly accepted connection must not leave that link open. JAX's
        ``FleetHost`` can append the connection after ``kill()`` copied
        its list (15 of 40 federations killed right after connecting kept
        seeing the host READY); the port checks ``_closing`` under the
        lock it appends with, so every such link reaches EOF."""
        for trial in range(40):
            host = FleetHost(object(), hid="hx", registry=MetricsRegistry())
            s = socket.create_connection(("127.0.0.1", host.port),
                                         timeout=5.0)
            try:
                host.kill()
                try:
                    assert s.recv(1) == b"", f"trial {trial}"
                except ConnectionResetError:
                    pass
                with host._lock:
                    assert host._conns == [], f"trial {trial}"
            finally:
                s.close()
                host.close()

    def test_drain_migrate_across_hosts(self, jlm, weights):
        """``retire_host(migrate=True)`` hands a host's work back as
        ``RequestMigrated`` with its newest snapshots, and the requests
        finish on the survivor equal to JAX's streams."""
        specs = _mixed_specs(4, np.random.default_rng(3), steps=14)
        refs = _serial_refs(jlm, specs)
        with host_pair(weights, snapshot_every=1, steps_per_dispatch=1,
                       chaos={"stall_rate": 1.0, "stall_s": 0.01}) as hosts:
            with FleetFederation(hosts, gossip_tick_s=0.03) as fed:
                futs = _submit_all(fed, specs)
                _wait(lambda: _per_host(fed)["h0"]["inflight"] > 0,
                      msg="h0 has in-flight work")
                assert fed.retire_host("h0", migrate=True, timeout=30)
                _assert_streams(futs, refs)
                st = _assert_ledger(fed)
                assert st["migrated"] >= 1
                assert _per_host(fed)["h0"]["state"] == "retired"


# ------------------------------------------------------------ crash drills
def _crash_drill(fed, kill, victim, jlm, n=6, steps=20):
    """Submit mixed traffic, kill ``victim`` once the router holds a
    published snapshot of a request in flight there, and hold every
    completion to JAX's stream, the ledger balanced and the victim's
    requests re-adopted from their snapshots."""
    specs = _mixed_specs(n, np.random.default_rng(4), steps=steps)
    refs = _serial_refs(jlm, specs)
    futs = _submit_all(fed, specs)
    _wait(lambda: fed.stats()["federation"]["snapshots"] >= 2
          and _victim_has_snapshot(fed, victim), timeout=120,
          tick=0.005, msg="router holds the victim's snapshots")
    kill()
    _assert_streams(futs, refs)
    st = _assert_ledger(fed)
    assert st["completed"] == n
    assert st["deaths"] >= 1
    assert st["handoff_resumes"] >= 1
    assert st["degraded_mode"] is True
    return st


DRILL_FLEET = dict(snapshot_every=1, steps_per_dispatch=1,
                   chaos={"stall_rate": 1.0, "stall_s": 0.02})


class TestFederationCrash:
    def test_in_process_kill_bit_exact(self, tmp_path, jlm, weights):
        """The tier-1 sibling of the SIGKILL drill: an in-process
        ``FleetHost.kill()`` (heartbeat stops, every socket dies, no
        goodbye) mid-stream; the victims resume on the survivor from
        their newest snapshots, equal to JAX's streams."""
        hb = str(tmp_path)
        with host_pair(weights, hb_dir=hb, **DRILL_FLEET) as hosts:
            with FleetFederation(hosts, heartbeat_dir=hb,
                                 suspect_after_s=0.5,
                                 dead_after_s=600.0) as fed:
                _crash_drill(fed, hosts[1].kill, "h1", jlm)

    @pytest.mark.slow
    def test_sigkill_whole_process_bit_exact(self, tmp_path, jlm, weights):
        """Two fleet-host processes (``spawn_host(..., device="cpu")``,
        the builder naming ``jax_weight_fleet``) behind one router; one
        is SIGKILLed mid-stream. Every completion equals JAX's stream,
        nothing is lost, the ledger balances, the victims resume from
        their snapshots, and neither child ever imported JAX."""
        hb = str(tmp_path / "hb")
        spec = {"heartbeat_dir": hb, "heartbeat_interval": 0.05,
                "builder": BUILDER,
                "builder_kwargs": dict(weights=weights, **DRILL_FLEET)}
        handles = []
        fed = None
        try:
            for hid in ("h0", "h1"):
                kw = dict(spec["builder_kwargs"],
                          report=str(tmp_path / f"{hid}.json"))
                handles.append(spawn_host(
                    dict(spec, hid=hid, builder_kwargs=kw), device="cpu"))
            hh0, hh1 = handles
            fed = FleetFederation(handles, heartbeat_dir=hb,
                                  suspect_after_s=0.5, dead_after_s=600.0)
            _crash_drill(fed, hh1.kill, "h1", jlm)
            assert not hh1.alive
            for hid, hh in (("h0", hh0), ("h1", hh1)):
                rep = json.loads((tmp_path / f"{hid}.json").read_text())
                assert rep == {"pid": hh.pid, "jax": False,
                               "dl4j_tpu": False, "device": "cpu"}
        finally:
            if fed is not None:
                fed.close()
            for hh in handles:
                if hh.alive:
                    hh.terminate()


# ------------------------------------------------------------ wire safety
def _frames(send, header, blob=b"", **kw):
    a, b = socket.socketpair()
    try:
        send(a, header, blob, **kw)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


WIRE_CASES = [
    ({"op": "stats", "id": 7}, b"payload"),
    ({"op": "submit", "id": 3, "prompt": [1, 2, 3], "max_tokens": 5,
      "temperature": 0.9, "top_k": 5, "seed": 2001, "deadline_s": 1.5},
     b""),
    ({"op": "snapshot", "id": 12, "count": 4}, bytes(range(256)) * 9),
    ({"op": "error", "id": 1, "etype": "RequestMigrated",
      "message": "host h0 retiring: é", "snapshot_count": 2}, b"\x00\xff"),
]


class TestFederationWire:
    def test_read_msg_roundtrip(self):
        a, b = socket.socketpair()
        try:
            _send_msg(a, {"op": "stats", "id": 7}, b"payload")
            assert _read_msg(b) == ({"op": "stats", "id": 7}, b"payload")
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("case", range(len(WIRE_CASES)))
    def test_frames_byte_identical_to_jax(self, case):
        """The port's frames are JAX's ``_send_msg`` output byte for byte,
        and each package's ``_read_msg`` reads the other's."""
        from deeplearning4j_tpu.parallel import federation as jfed

        header, blob = WIRE_CASES[case]
        ours = _frames(_send_msg, header, blob)
        theirs = _frames(jfed._send_msg, header, blob)
        assert ours == theirs
        assert struct.unpack(">I", ours[:4])[0] == len(ours) - 4
        for send, read in ((_send_msg, jfed._read_msg),
                           (jfed._send_msg, _read_msg)):
            a, b = socket.socketpair()
            try:
                send(a, header, blob)
                assert read(b) == (header, blob)
            finally:
                a.close()
                b.close()

    def test_chaos_corrupted_frames_byte_identical_to_jax(self):
        """A seeded corrupt draw flips the same bit in both packages."""
        from deeplearning4j_tpu.parallel import federation as jfed
        from deeplearning4j_tpu.parallel.resilience import (
            ChaosPolicy as JChaos)

        for header, blob in WIRE_CASES:
            ours = _frames(_send_msg, header, blob,
                           chaos=ChaosPolicy(seed=3, frame_corrupt_rate=1.0))
            theirs = _frames(jfed._send_msg, header, blob,
                             chaos=JChaos(seed=3, frame_corrupt_rate=1.0))
            assert ours == theirs

    def test_json_safe_matches_jax(self):
        from deeplearning4j_tpu.parallel import federation as jfed

        tree = {"a": np.float32(1.5), 2: [np.int64(3), (np.arange(3),)],
                "s": {1, 2}, "n": None, "o": object.__name__,
                "arr": np.eye(2), "b": np.bool_(True)}
        assert _json_safe(tree) == jfed._json_safe(tree)
        assert json.dumps(_json_safe(tree)) == json.dumps(
            jfed._json_safe(tree))

    def test_read_msg_rejects_oversize_typed(self):
        a, b = socket.socketpair()
        try:
            a.sendall((1 << 30).to_bytes(4, "big"))
            with pytest.raises(FrameTooLarge):
                _read_msg(b, max_frame_bytes=1 << 20)
        finally:
            a.close()
            b.close()

    def test_send_msg_rejects_oversize_typed(self):
        a, b = socket.socketpair()
        try:
            with pytest.raises(FrameTooLarge):
                _send_msg(a, {"op": "adopt", "id": 1}, b"x" * 2048,
                          max_frame_bytes=1024)
        finally:
            a.close()
            b.close()

    def test_broker_read_frame_rejects_oversize_typed(self):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack(">cH", b"P", 1) + b"t"
                      + struct.pack(">I", 1 << 29))
            with pytest.raises(FrameTooLarge):
                read_frame(b, max_frame_bytes=1 << 20)
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("payload", [
        b"\x00\x00\x00\x10" + b"not json at all!",    # unreadable JSON
        b"\x00\x00\x00\x04" + b"[12]",                # not an object
        b"\x00\x00\x00\x02" + b"{}",                  # no op
        b"\xff\xff\xff\xf0" + b"x" * 12,              # header overruns
        b"\x00\x00",                                   # no header length
    ])
    def test_corrupt_header_rejected_typed(self, payload):
        a, b = socket.socketpair()
        try:
            a.sendall(len(payload).to_bytes(4, "big") + payload)
            with pytest.raises(FederationProtocolError):
                _read_msg(b)
        finally:
            a.close()
            b.close()

    def test_chaos_corrupt_draw_breaks_frame_typed(self):
        a, b = socket.socketpair()
        try:
            ch = ChaosPolicy(seed=3, frame_corrupt_rate=1.0)
            _send_msg(a, {"op": "stats", "id": 1}, chaos=ch)
            assert ch.injected_frame_corrupt == 1
            with pytest.raises(FederationProtocolError):
                _read_msg(b)
        finally:
            a.close()
            b.close()

    def test_host_answers_protocol_error_and_closes(self):
        """A structurally invalid frame gets a typed ``protocol_error``
        frame back and the connection closes (the fleet is a bare stub:
        the frame is refused before any op reaches it)."""
        host = FleetHost(object(), hid="hx", registry=MetricsRegistry())
        try:
            s = socket.create_connection(("127.0.0.1", host.port),
                                         timeout=10)
            hdr = b"\xff\xff\xff\xf0" + b"x" * 12
            s.sendall(len(hdr).to_bytes(4, "big") + hdr)
            reply = _read_msg(s)
            assert reply is not None
            assert reply[0]["op"] == "protocol_error"
            assert reply[0]["etype"] == "FederationProtocolError"
            assert _read_msg(s) is None
            s.close()
        finally:
            host.close()

    def test_host_answers_unknown_op_typed(self):
        host = FleetHost(object(), hid="hx", registry=MetricsRegistry())
        try:
            s = socket.create_connection(("127.0.0.1", host.port),
                                         timeout=10)
            _send_msg(s, {"op": "reboot", "id": 5})
            hdr, blob = _read_msg(s)
            assert hdr == {"op": "error", "id": 5,
                           "etype": "FederationProtocolError",
                           "message": "unknown op 'reboot'"}
            s.close()
        finally:
            host.close()


# ----------------------------------------------------------- chaos modes
def _net_sequence(make, n=120):
    sleeps = []
    ch = make(seed=9, conn_refused_rate=0.3, partition_rate=0.2,
              partition_s=0.0, frame_corrupt_rate=0.2, sleep=sleeps.append)
    seq = []
    for _ in range(n):
        try:
            ch.net_connect_fault()
            seq.append("ok")
        except ConnectionRefusedError:
            seq.append("refused")
        seq.append(ch.net_fault_mode(64))
    return seq, ch


def _legacy_pattern(make, transient=TransientDispatchError, **kw):
    ch = make(seed=11, transient_rate=0.3, hard_rate=0.1, **kw)
    fn = ch.wrap(lambda: "ok")
    seq = []
    for _ in range(200):
        if kw:
            ch.net_connect_fault()          # rate 0: no draw
            assert ch.net_fault_mode(64) is None
            assert not ch.net_partitioned()
        try:
            seq.append(fn() is not None)
        except transient:
            seq.append("transient")
        except RuntimeError:
            seq.append("hard")
    return seq


ZERO_NET = dict(conn_refused_rate=0.0, partition_rate=0.0, partition_s=5.0,
                slow_link_factor=1.0, frame_corrupt_rate=0.0)


class TestFederationChaos:
    def test_network_faults_deterministic(self):
        s1, c1 = _net_sequence(ChaosPolicy)
        s2, c2 = _net_sequence(ChaosPolicy)
        assert s1 == s2
        assert c1.injected_conn_refused == c2.injected_conn_refused > 0
        assert c1.injected_partition == c2.injected_partition > 0
        assert c1.injected_frame_corrupt == c2.injected_frame_corrupt > 0

    def test_network_faults_pinned_to_jax(self):
        """The port's seeded network faults are JAX's draws."""
        from deeplearning4j_tpu.parallel.resilience import (
            ChaosPolicy as JChaos)

        ours, oc = _net_sequence(ChaosPolicy)
        theirs, jc = _net_sequence(JChaos)
        assert ours == theirs
        for k in ("injected_conn_refused", "injected_partition",
                  "injected_frame_corrupt"):
            assert getattr(oc, k) == getattr(jc, k) > 0

    def test_partition_window_and_slow_link(self):
        sleeps = []
        ch = ChaosPolicy(seed=1, partition_rate=1.0, partition_s=30.0,
                         sleep=sleeps.append)
        assert not ch.net_partitioned()
        assert ch.net_fault_mode(100) == "partition"
        assert ch.net_partitioned()   # the window is armed
        a, b = socket.socketpair()
        try:
            with pytest.raises(OSError):
                _send_msg(a, {"op": "stats"}, chaos=ch)
        finally:
            a.close()
            b.close()
        slow = ChaosPolicy(seed=1, slow_link_factor=3.0, sleep=sleeps.append)
        assert slow.net_fault_mode(ChaosPolicy.LINK_BYTES_PER_S) is None
        assert slow.injected_slow_link == 1
        assert sleeps and abs(sleeps[-1] - 2.0) < 1e-9

    def test_legacy_sequences_pinned(self):
        """Zero-rate network knobs draw nothing: a seeded policy's replica
        faults are unchanged with them present, in the port and against
        JAX's sequence."""
        from deeplearning4j_tpu.parallel.resilience import (
            ChaosPolicy as JChaos, TransientDispatchError as JTransient)

        base = _legacy_pattern(ChaosPolicy)
        assert base == _legacy_pattern(ChaosPolicy, **ZERO_NET)
        assert "transient" in base and "hard" in base
        assert base == _legacy_pattern(JChaos, JTransient) == \
            _legacy_pattern(JChaos, JTransient, **ZERO_NET)


# -------------------------------------------------------------- metrics
@pytest.mark.metrics
class TestFederationMetrics:
    def test_one_scrape_shows_every_host(self, jlm, weights):
        """``metrics_sources()`` carries the router's registry and each
        host's gossiped families under ``host=``, and the port's
        ``KerasBackendServer.metrics_text`` puts ``model=`` on top."""
        from deeplearning4j_torch.modelimport.server import \
            KerasBackendServer

        with host_pair(weights) as hosts:
            with FleetFederation(hosts, stats_every_s=0.05,
                                 gossip_tick_s=0.03) as fed:
                specs = _mixed_specs(4, np.random.default_rng(5))
                _assert_streams(_submit_all(fed, specs),
                                _serial_refs(jlm, specs))
                _wait(lambda: len(fed.metrics_sources()) == 3,
                      msg="both hosts gossiped families")
                # a gossip round after the last completion carries it
                _wait(lambda: 'fleet_completed_total{host="h0"}'
                      in render_text(fed.metrics_sources()),
                      msg="gossiped completions")
                text = render_text(fed.metrics_sources())
                assert "fed_submitted_total 4" in text
                assert 'fleet_submitted_total{host="h0"}' in text
                assert 'fleet_submitted_total{host="h1"}' in text
                assert "fed_degraded_mode 0" in text
                srv = KerasBackendServer()
                with srv._lock:
                    srv._generators["m0"] = fed
                text = srv.metrics_text()
                assert 'fed_submitted_total{model="m0"} 4' in text
                assert ('fleet_submitted_total{model="m0",host="h0"}'
                        in text)


# ----------------------------------------------------- no CPU fallback
class TestHostDevice:
    @pytest.mark.parametrize("device", [None, "cuda"])
    def test_host_without_a_card_fails_before_ready(self, device,
                                                    monkeypatch, capsys,
                                                    weights):
        """A spec with no device (the card) or naming ``cuda`` on a host
        without one raises before the builder runs and before READY: the
        host never serves on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        built = []
        monkeypatch.setattr(sys.modules[__name__], "jax_weight_fleet",
                            lambda **kw: built.append(kw))
        spec = {"hid": "hx", "builder": HERE,
                "builder_kwargs": {"weights": weights}}
        if device is not None:
            spec["device"] = device
        with pytest.raises(RuntimeError, match="device='cpu'|no CUDA"):
            fed_mod.main(["--spec", json.dumps(spec)])
        assert built == []
        assert "FLEETHOST READY" not in capsys.readouterr().out

    def test_builder_gets_the_spec_device(self, monkeypatch, weights):
        """``main`` hands the builder the spec's device; ``spawn_host``'s
        ``device=`` lands in the spec."""
        seen = []

        def fake_builder(**kw):
            seen.append(kw)
            raise KeyboardInterrupt   # stop before serving

        monkeypatch.setattr(sys.modules[__name__], "jax_weight_fleet",
                            fake_builder)
        spec = {"hid": "hx", "device": "cpu", "builder": HERE,
                "builder_kwargs": {"weights": weights}}
        with pytest.raises(KeyboardInterrupt):
            fed_mod.main(["--spec", json.dumps(spec)])
        assert seen == [{"device": torch.device("cpu"), "weights": weights}]

    @pytest.mark.slow
    def test_spawned_host_without_a_card_surfaces_the_error(self):
        """Spawned with no device on a host without a card, the child
        exits before READY and ``spawn_host`` raises with its output."""
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        with pytest.raises(RuntimeError, match="before READY") as err:
            spawn_host({"hid": "hx"}, timeout=120)
        assert "device='cpu'" in str(err.value)

    def test_modules_import_no_jax(self):
        """``federation.py`` and ``elastic.py`` (the child's whole import
        path from ``python -m``) import neither JAX nor the JAX
        package."""
        for name in ("federation.py", "elastic.py"):
            path = os.path.join(ROOT, "deeplearning4j_torch", "parallel",
                                name)
            tree = ast.parse(open(path).read())
            roots = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    roots |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    roots.add(node.module.split(".")[0])
            assert not roots & {"jax", "jaxlib", "deeplearning4j_tpu"}
        assert set(fed_mod.__all__) == {
            "FleetFederation", "FleetHost", "HostHandle", "HostUnavailable",
            "FederationProtocolError", "spawn_host",
            "build_generation_fleet", "FED_MAX_FRAME_BYTES", "READY",
            "SUSPECT", "DEAD", "RETIRED"}


# ------------------------------------------------------------- interop
class TestFederationInterop:
    @pytest.mark.slow
    def test_port_router_over_jax_and_port_hosts(self, jlm, weights):
        """The port's router in front of a JAX ``FleetHost`` (its JAX
        fleet) and a port one: both take traffic, every stream equals
        JAX's, and when the port host dies mid-stream the JAX host adopts
        the port's snapshots. The JAX host is in process: its listening
        socket is bound when its constructor returns, which is the
        readiness signal the router's connect waits on (the ROADMAP C14
        rule: wait on the JAX side's own signal)."""
        from deeplearning4j_tpu.parallel import federation as jfed

        jfl = jfed.build_generation_fleet(replicas=1, max_length=32,
                                          **DRILL_FLEET)
        jhost = jfed.FleetHost(jfl, hid="jax")
        pfl = jax_weight_fleet(weights=weights, device="cpu", **DRILL_FLEET)
        phost = FleetHost(pfl, hid="port")
        try:
            with FleetFederation([jhost, phost]) as fed:
                _wait(lambda: fed.stats()["federation"]["ready"] == 2,
                      msg="both hosts READY")
                st = _crash_drill(fed, phost.kill, "port", jlm, n=8)
                per = _per_host(fed)
                assert per["jax"]["completed"] > 0
                assert per["port"]["dispatched"] > 0
                assert st["handoff_fallbacks"] == 0
        finally:
            phost.close()
            jhost.close()
            pfl.close()
            jfl.close()

    @pytest.mark.slow
    def test_jax_router_over_port_hosts(self, jlm, weights):
        """JAX's ``FleetFederation`` routes the mixed traffic over two
        port hosts and gets JAX's own streams back."""
        from deeplearning4j_tpu.parallel import federation as jfed

        specs = _mixed_specs(6, np.random.default_rng(6))
        refs = _serial_refs(jlm, specs)
        with host_pair(weights) as hosts:
            with jfed.FleetFederation(hosts) as fed:
                _assert_streams(_submit_all(fed, specs), refs)
                st = _assert_ledger(fed)
                assert st["completed"] == 6
                per = _per_host(fed)
                assert per["h0"]["dispatched"] > 0
                assert per["h1"]["dispatched"] > 0
