"""Port parity: KVSnapshots cross between the JAX package and the port
(``deeplearning4j_torch/parallel/handoff.py`` and the port's
``GenerationServer.export_request`` / ``adopt_request``).

The LM is ``tests/test_handoff.py``'s (vocab 17, d_model 16, 2 heads of
d=8, one block, JAX init seed 3), its JAX weights copied into the port's
model, in f32 and in bf16. Every check holds the port to the JAX package on
the CPU:

- wire bytes: a snapshot the JAX server wrote is read by the port and
  written back byte-identical, and the port's ``downgrade_snapshot`` gives
  JAX's v2 bytes; damaged, truncated and unknown-version snapshots fail
  with the exception types JAX raises;
- adoption both ways: a mid-stream snapshot written by one package and
  adopted by the other package's server finishes equal to the JAX
  server's uninterrupted stream, token for token (greedy, sampled, greedy
  over int8 KV pages, and sampled over a bf16 model's bf16 pages, whose
  leaves the port carries as raw 16-bit words labelled ``bfloat16``; the
  tolerance is exact token equality);
- typed refusals: ``SnapshotUnavailable`` for a request no longer resident,
  ``SnapshotUnsupported`` for another page size or a leaf dtype the reader
  does not know.
"""

import json
import struct
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.models.zoo import (  # noqa: E402
    TransformerLM as JaxTransformerLM)
from deeplearning4j_tpu.parallel import handoff as jh  # noqa: E402
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.parallel import handoff as th  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 17
KW = dict(num_labels=V, max_length=16, d_model=16, n_heads=2, n_blocks=1)
SERVER = dict(slots=2, page_size=4, steps_per_dispatch=2)
# (prompt, max_tokens, temperature, top_k, seed, kv_dtype)
SPECS = {
    "greedy": (np.array([1, 2, 3, 4], np.int64), 12, 0.0, 0, 0, None),
    "sampled": (np.array([1, 2, 3, 4], np.int64), 12, 0.9, 5, 77, None),
    "int8": (np.array([5, 1, 16, 2, 9], np.int64), 12, 0.0, 0, 0, "int8"),
    "bf16": (np.array([1, 2, 3, 4], np.int64), 12, 0.9, 5, 77, None),
}
#: the model's dtype for a spec (f32 unless named here)
MODEL_DTYPE = {"bf16": "bfloat16"}


@pytest.fixture(scope="module")
def all_nets():
    """(JAX net, port net) per model dtype, the JAX weights (bf16 widened
    exactly to f32 on the way) copied into the port's model."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jnet = JaxTransformerLM(seed=3, dtype=dtype, **KW).init()
        tnet = TransformerLM(dtype=dtype, **KW).init(device="cpu")
        params_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jnet.params), tnet)
        out[dtype] = jnet, tnet
    return out


def _nets_for(all_nets, name):
    return all_nets[MODEL_DTYPE.get(name, "float32")]


@pytest.fixture(scope="module")
def nets(all_nets):
    return all_nets["float32"]


@contextmanager
def serving(cls, net, **kw):
    srv = cls(net, V, **kw)
    try:
        yield srv
    finally:
        srv.close()


def _run_to_snapshot(cls, net, spec, **kw):
    """One request to completion on a server snapshotting every 4 tokens:
    (completed tokens, the last snapshot it published)."""
    p, n, temp, top_k, seed, kv = spec
    with serving(cls, net, snapshot_every=4, kv_dtype=kv, **SERVER,
                 **kw) as srv:
        fut = srv.submit(p, n, temperature=temp, top_k=top_k, seed=seed)
        out = np.asarray(fut.result(timeout=120)).tolist()
        assert srv.stats()["handoff"]["snapshots"] >= 1
    snap = getattr(fut, "_kv_snapshot", None)
    assert snap is not None and 0 < snap.count < n   # genuinely mid-stream
    assert list(snap.tokens) == out[:snap.count]
    return out, snap


@pytest.fixture(scope="module")
def jax_runs(all_nets):
    return {name: _run_to_snapshot(JaxGenerationServer,
                                   _nets_for(all_nets, name)[0], spec)
            for name, spec in SPECS.items()}


@pytest.mark.parametrize("name", list(SPECS))
def test_jax_bytes_read_and_rewritten_byte_identical(jax_runs, name):
    _, jsnap = jax_runs[name]
    blob = jsnap.to_bytes()
    tsnap = th.KVSnapshot.from_bytes(blob)
    assert tsnap.verify() and tsnap.to_bytes() == blob
    assert tsnap.wire_bytes() == jsnap.wire_bytes() == len(blob)
    assert th.peek_snapshot(blob) == jh.peek_snapshot(blob)
    # and back: the port's bytes are read by the JAX package
    assert jh.KVSnapshot.from_bytes(tsnap.to_bytes()).to_bytes() == blob


@pytest.mark.parametrize("name", list(SPECS))
def test_downgrade_byte_identical_to_jax(jax_runs, name):
    _, jsnap = jax_runs[name]
    tsnap = th.KVSnapshot.from_bytes(jsnap.to_bytes())
    want = jh.downgrade_snapshot(jsnap).to_bytes()
    got = th.downgrade_snapshot(tsnap).to_bytes()
    assert got == want
    # a v2 blob at a v3 reader is refused the same way by both
    with pytest.raises(th.SnapshotUnsupported):
        th.KVSnapshot.from_bytes(got)
    with pytest.raises(jh.SnapshotUnsupported):
        jh.KVSnapshot.from_bytes(want)
    assert th.KVSnapshot.from_bytes(got, supported=2).to_bytes() == want


def _damaged(blob, how, mod):
    if how == "garbage":
        return b"not a snapshot at all"
    if how == "unknown_version":
        return blob[:4] + struct.pack("<H", 9) + blob[6:]
    if how == "truncated":
        return blob[:len(blob) - 7]
    snap = mod.KVSnapshot.from_bytes(blob)
    if how == "corrupt":
        return mod.corrupt_snapshot(snap).to_bytes()
    return mod.truncate_snapshot(snap).to_bytes()


@pytest.mark.parametrize("how", ["garbage", "unknown_version", "truncated",
                                 "corrupt", "truncate_payload"])
def test_bad_snapshots_rejected_with_jax_types(jax_runs, how):
    """Each package reads its own damaged copy; the port raises the
    exception type (by name and family) JAX raises."""
    blob = jax_runs["greedy"][1].to_bytes()
    outcome = {}
    for tag, mod in (("jax", jh), ("port", th)):
        with pytest.raises(Exception) as e:
            mod.KVSnapshot.from_bytes(_damaged(blob, how, mod))
        outcome[tag] = type(e.value).__name__
    assert outcome["port"] == outcome["jax"]
    if how != "truncated":
        assert outcome["port"] == "SnapshotInvalid"
    with pytest.raises(th.SnapshotInvalid):
        th.peek_snapshot(b"KVSN\x09\x00\x00\x00\x00\x00")


@pytest.mark.parametrize("name", list(SPECS))
def test_jax_snapshot_adopted_by_port(all_nets, jax_runs, name):
    _, tnet = _nets_for(all_nets, name)
    ref, jsnap = jax_runs[name]
    tsnap = th.KVSnapshot.from_bytes(jsnap.to_bytes())
    with serving(GenerationServer, tnet, kv_dtype=SPECS[name][5],
                 device="cpu", **SERVER) as srv:
        got = th.adopt_request(srv, tsnap).result(timeout=120).tolist()
        st = srv.stats()
    assert got == ref
    assert st["handoff"]["resumes"] == 1
    assert st["handoff"]["tokens_saved"] == jsnap.count
    assert st["prefills"] == 0                      # nothing recomputed


@pytest.mark.parametrize("name", list(SPECS))
def test_port_snapshot_adopted_by_jax(all_nets, jax_runs, name):
    jnet, tnet = _nets_for(all_nets, name)
    ref, _ = jax_runs[name]
    out, tsnap = _run_to_snapshot(GenerationServer, tnet, SPECS[name],
                                  device="cpu")
    assert out == ref
    jsnap = jh.KVSnapshot.from_bytes(tsnap.to_bytes())
    with serving(JaxGenerationServer, jnet, kv_dtype=SPECS[name][5],
                 **SERVER) as srv:
        got = jh.adopt_request(srv, jsnap).result(timeout=120).tolist()
        assert srv.stats()["handoff"]["resumes"] == 1
    assert got == ref


def test_export_of_a_finished_request_is_unavailable(nets):
    _, tnet = nets
    p, n, *_ = SPECS["greedy"]
    with serving(GenerationServer, tnet, device="cpu", **SERVER) as srv:
        fut = srv.submit(p, n)
        fut.result(timeout=120)
        with pytest.raises(th.SnapshotUnavailable):
            th.export_request(srv, fut, timeout=30)


def test_page_size_mismatch_is_unsupported(nets, jax_runs):
    _, tnet = nets
    tsnap = th.KVSnapshot.from_bytes(jax_runs["greedy"][1].to_bytes())
    with serving(GenerationServer, tnet, device="cpu", slots=2,
                 page_size=8) as srv:
        with pytest.raises(th.SnapshotUnsupported, match="page_size=4"):
            srv.adopt_request(tsnap)
    with serving(GenerationServer, tnet, device="cpu", kv_dtype="int8",
                 **SERVER) as srv:
        with pytest.raises(th.SnapshotUnsupported, match="kv_dtype"):
            srv.adopt_request(tsnap)


def test_unknown_leaf_dtype_is_unsupported(jax_runs):
    """A header naming a leaf dtype the reader does not know is refused
    typed, before any payload is trusted."""
    blob = jax_runs["greedy"][1].to_bytes()
    _, hlen = struct.unpack_from("<HI", blob, 4)
    hdr = json.loads(blob[10:10 + hlen])
    hdr["leaves"][0][2] = "float7"
    head = json.dumps(hdr, sort_keys=True).encode()
    bad = (blob[:4] + struct.pack("<HI", 3, len(head)) + head
           + blob[10 + hlen:])
    with pytest.raises(th.SnapshotUnsupported, match="float7"):
        th.KVSnapshot.from_bytes(bad)
