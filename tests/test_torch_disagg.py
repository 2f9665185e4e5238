"""Port parity: disaggregated prefill/decode roles in the port's
``GenerationServer`` against the JAX package's (``tests/test_disagg.py``'s
``TestPrefillExport`` and ``TestDeadlineAcrossTiers`` cases), on the CPU.

A prefill-role server resolves a request's future to the ``KVSnapshot``
holding its first token and frees the slot; a decode-role server adopts it
and finishes the stream. Every completion must equal the serial reference
(f32) or the unified server's (int8) token for token, and the snapshots
cross between the packages both ways with the same result. Both packages'
nets hold the JAX ``TransformerLM``'s weights (``params_from_jax``).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.parallel.handoff import (  # noqa: E402
    KVSnapshot as JaxKVSnapshot)
from deeplearning4j_tpu.parallel.resilience import (  # noqa: E402
    DeadlineExceeded as JaxDeadlineExceeded)
from deeplearning4j_torch.parallel.handoff import (  # noqa: E402
    KVSnapshot, SnapshotUnavailable, export_request)
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    ChaosPolicy, Deadline, DeadlineExceeded)
from tests.test_torch_speculative import V, jax_pair, make_server  # noqa

pytestmark = pytest.mark.torch_port

TIER = dict(slots=2, page_size=4)
GREEDY = (np.array([1, 2, 3, 4], np.int64), 12, {})
SAMPLED = (np.array([1, 2, 3, 4], np.int64), 12,
           dict(temperature=0.9, top_k=5, seed=77))


@pytest.fixture(scope="module")
def lm():
    return jax_pair(3, 16)


def _serial(lm, spec):
    jnet, _ = lm
    p, steps, kw = spec
    if not kw:
        return jzoo.greedy_generate(jnet, p[None], steps, V)[0].tolist()
    return jzoo.sample_generate(jnet, p[None], steps, V, **kw)[0].tolist()


def _one(srv, call):
    """``call(srv)`` -> future; its result, with the server closed."""
    try:
        return call(srv).result(timeout=120)
    finally:
        srv.close()


@pytest.mark.parametrize("spec", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_export_and_adopt_equal_serial(lm, spec):
    """A prefill-role server exports the request with exactly its first
    token, frees the slot and counts the export; a decode-role server
    adopts the snapshot and finishes the serial reference's stream."""
    p, steps, kw = spec
    ref = _serial(lm, spec)
    pre = make_server("port", lm, role="prefill", **TIER)
    try:
        snap = pre.submit(p, steps, **kw).result(timeout=120)
        assert isinstance(snap, KVSnapshot)
        assert snap.count == 1 and snap.tokens == ref[:1]
        st = pre.stats()
        assert st["role"] == "prefill"
        assert st["handoff"]["prefill_exports"] == 1
        assert st["active_slots"] == 0 and st["queued"] == 0
        assert st["pages"]["pages_refcounted"] == 0
    finally:
        pre.close()
    dec = make_server("port", lm, role="decode", **TIER)
    try:
        assert dec.adopt_request(snap).result(timeout=120).tolist() == ref
        assert dec.stats()["role"] == "decode"
        assert dec.stats()["handoff"]["resumes"] == 1
    finally:
        dec.close()


def test_export_int8_equals_unified_int8(lm):
    """int8 pages across the tier boundary: the adopted completion equals
    the unified int8 server's, in both packages, and the port's equals
    JAX's."""
    p, steps, kw = SAMPLED
    outs = {}
    for which in ("jax", "port"):
        ref = _one(make_server(which, lm, kv_dtype="int8", **TIER),
                   lambda s: s.submit(p, steps, **kw)).tolist()
        snap = _one(make_server(which, lm, kv_dtype="int8", role="prefill",
                                **TIER), lambda s: s.submit(p, steps, **kw))
        assert snap.kv_dtype == "int8"
        out = _one(make_server(which, lm, kv_dtype="int8", role="decode",
                               **TIER), lambda s: s.adopt_request(snap))
        assert out.tolist() == ref, which
        outs[which] = ref
    assert outs["port"] == outs["jax"]


def test_single_token_request_returns_tokens(lm):
    """max_tokens=1 finishes on the prefill token: the request retires with
    its tokens, never a snapshot, and nothing is exported."""
    p = np.array([1, 2, 3], np.int64)
    ref = _serial(lm, (p, 1, {}))
    pre = make_server("port", lm, role="prefill", **TIER)
    try:
        out = pre.submit(p, 1).result(timeout=120)
        assert not isinstance(out, KVSnapshot) and out.tolist() == ref
        assert pre.stats()["handoff"]["prefill_exports"] == 0
    finally:
        pre.close()


@pytest.mark.parametrize("role", ["bogus", "PREFILL", ""])
def test_role_validation(lm, role):
    for which in ("jax", "port"):
        with pytest.raises(ValueError, match="role"):
            make_server(which, lm, role=role, **TIER)


def test_explicit_export_kv_overrides_role(lm):
    """``export_kv=False`` decodes here on a prefill-role server (the
    degraded co-located mode) and ``export_kv=True`` exports from a unified
    one."""
    p, steps, _ = GREEDY
    ref = _serial(lm, GREEDY)
    out = _one(make_server("port", lm, role="prefill", **TIER),
               lambda s: s.submit(p, steps, export_kv=False))
    assert out.tolist() == ref
    snap = _one(make_server("port", lm, **TIER),
                lambda s: s.submit(p, steps, export_kv=True))
    assert isinstance(snap, KVSnapshot) and snap.tokens == ref[:1]


def test_snapshot_carries_remaining_budget(lm):
    """The wire carries the request's remaining deadline as a duration:
    bounded by the original budget, kept by a byte round trip, None
    without a deadline."""
    p, steps, _ = GREEDY
    snap = _one(make_server("port", lm, role="prefill", **TIER),
                lambda s: s.submit(p, steps, deadline_s=120.0))
    assert 0.0 < snap.deadline_remaining <= 120.0
    back = KVSnapshot.from_bytes(snap.to_bytes())
    assert back.deadline_remaining == snap.deadline_remaining
    snap2 = _one(make_server("port", lm, role="prefill", **TIER),
                 lambda s: s.submit(p, steps))
    assert snap2.deadline_remaining is None
    assert KVSnapshot.from_bytes(snap2.to_bytes()).deadline_remaining is None


def test_adopting_exhausted_budget_fails_typed(lm):
    """A snapshot whose carried budget is spent fails ``DeadlineExceeded``
    at the decode tier, in both packages."""
    p, steps, _ = GREEDY
    snap = _one(make_server("port", lm, role="prefill", **TIER),
                lambda s: s.submit(p, steps))
    kw = {k: getattr(snap, k) for k in KVSnapshot.__slots__
          if k != "checksum"}
    kw["deadline_remaining"] = 1e-4
    expired = KVSnapshot(**kw)
    time.sleep(0.001)
    jax_wire = JaxKVSnapshot.from_bytes(expired.to_bytes())
    for which, blob, exc in (("port", expired, DeadlineExceeded),
                             ("jax", jax_wire, JaxDeadlineExceeded)):
        with pytest.raises(exc, match="budget"):
            _one(make_server(which, lm, role="decode", **TIER),
                 lambda s, b=blob: s.adopt_request(b))


def test_export_request_clamps_to_deadline(lm):
    """``export_request`` waits ``min(timeout, remaining)``: a spent budget
    fails typed at once even with the default 30 s timeout."""
    p = np.array([1, 2, 3, 4], np.int64)
    srv = make_server("port", lm, **TIER)
    try:
        fut = srv.submit(p, 12)
        fut._deadline = Deadline(1e-4)
        time.sleep(0.005)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            export_request(srv, fut, timeout=30.0)
        assert time.monotonic() - t0 < 5.0
        fut._deadline = None
        assert fut.result(timeout=120).size == 12
    finally:
        srv.close()


@pytest.mark.parametrize("spec", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("src, dst", [("jax", "port"), ("port", "jax")])
def test_snapshots_cross_packages(lm, spec, kv_dtype, src, dst):
    """A prefill-role server of one package exports, a decode-role server
    of the other adopts the bytes, and the completion equals the exporting
    package's unified server's."""
    p, steps, kw = spec
    ref = _one(make_server(src, lm, kv_dtype=kv_dtype, **TIER),
               lambda s: s.submit(p, steps, **kw)).tolist()
    snap = _one(make_server(src, lm, kv_dtype=kv_dtype, role="prefill",
                            **TIER), lambda s: s.submit(p, steps, **kw))
    blob = snap.to_bytes()
    wire = (KVSnapshot if dst == "port" else JaxKVSnapshot).from_bytes(blob)
    out = _one(make_server(dst, lm, kv_dtype=kv_dtype, role="decode", **TIER),
               lambda s: s.adopt_request(wire))
    assert np.asarray(out).tolist() == ref


def test_dropped_transfer_fails_typed(lm):
    """An injected transfer drop fails the request ``SnapshotUnavailable``
    with no snapshot attached, and frees the slot."""
    p, steps, _ = GREEDY
    chaos = ChaosPolicy(seed=0, handoff_drop_rate=1.0)
    srv = make_server("port", lm, role="prefill", chaos=chaos, **TIER)
    try:
        fut = srv.submit(p, steps)
        with pytest.raises(SnapshotUnavailable, match="dropped"):
            fut.result(timeout=120)
        assert getattr(fut, "_kv_snapshot", None) is None
        st = srv.stats()
        assert st["failed"] == 1 and st["handoff"]["prefill_exports"] == 0
        assert st["active_slots"] == 0 and chaos.injected_handoff_drop == 1
    finally:
        srv.close()
