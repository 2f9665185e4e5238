"""Port parity: device meshes and tensor-parallel paged decode
(``deeplearning4j_torch/parallel/mesh.py``, ``GenerationServer(mesh=,
tp=)``, the head-sharded paged write and read, cross-tp handoff, replica
groups) against ``tests/test_mesh_generation.py``'s JAX reference.

The LM is that file's (vocab 17, d_model 16, 4 heads of d=4, one block,
JAX init seed 5), its JAX weights copied into the port's model; servers
run 2 slots of 4-token pages. The port's meshes name the host several
times (``Mesh([cpu] * tp, ("model",))``: each entry a shard with pools of
its own), the counterpart of the JAX tests' eight XLA CPU devices; JAX
runs its own servers over those eight devices. Tolerances: token streams
are compared exactly (tp>1 is bitwise tp=1 in both packages); geometry
errors carry JAX's messages word for word.
"""

import time
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.models.zoo import (  # noqa: E402
    TransformerLM as JaxTransformerLM)
from deeplearning4j_tpu.parallel import fleet as jfleet  # noqa: E402
from deeplearning4j_tpu.parallel import mesh as jmesh  # noqa: E402
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_tpu.parallel.handoff import (  # noqa: E402
    KVSnapshot as JaxKVSnapshot)
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.nn.conf.layers import (  # noqa: E402
    paged_attention as ppa)
from deeplearning4j_torch.parallel.fleet import (  # noqa: E402
    ReplicaFleet, device_groups)
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.parallel.handoff import KVSnapshot  # noqa: E402
from deeplearning4j_torch.parallel.mesh import (  # noqa: E402
    MODEL_AXIS, Mesh, MeshGeometryError, all_gather, data_mesh,
    data_model_mesh, model_mesh)
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    ChaosPolicy, ResilienceError)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 17
KW = dict(num_labels=V, max_length=16, d_model=16, n_heads=4, n_blocks=1)
SERVER = dict(slots=2, page_size=4)
CPU = torch.device("cpu")
GREEDY = (np.array([1, 2, 3, 4], np.int64), 12, 0.0, 0, 0)
SAMPLED = (np.array([1, 2, 3, 4], np.int64), 12, 0.9, 5, 77)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops under several xdist workers: one intra-op thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(tp, axes=(MODEL_AXIS,)):
    return Mesh([CPU] * tp, axes)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxTransformerLM(seed=5, **KW).init()
    tnet = TransformerLM(**KW).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


@contextmanager
def serving(cls, net, **kw):
    srv = cls(net, V, **SERVER, **kw)
    try:
        yield srv
    finally:
        srv.close()


def _submit(srv, spec):
    p, steps, temp, top_k, seed = spec
    return srv.submit(p, steps, temperature=temp, top_k=top_k, seed=seed)


def _serve(cls, net, specs, **kw):
    with serving(cls, net, **kw) as srv:
        return [np.asarray(_submit(srv, s).result(timeout=120)).tolist()
                for s in specs]


@pytest.fixture(scope="module")
def refs(nets):
    """The port's one-device streams (greedy, sampled, int8 greedy)."""
    _, tnet = nets
    greedy, sampled = _serve(GenerationServer, tnet, (GREEDY, SAMPLED),
                             device="cpu")
    int8, = _serve(GenerationServer, tnet, (GREEDY,), device="cpu",
                   kv_dtype="int8")
    return {"greedy": greedy, "sampled": sampled, "int8": int8}


@pytest.fixture(scope="module")
def jax_streams(nets):
    """JAX's tp=2 (greedy and sampled, one server) and tp=4 streams."""
    jnet, _ = nets
    g2, s2 = _serve(JaxGenerationServer, jnet, (GREEDY, SAMPLED), tp=2)
    g4, = _serve(JaxGenerationServer, jnet, (GREEDY,), tp=4)
    return {2: (g2, s2), 4: (g4,)}


def _messages(port_call, jax_call, exc_port=MeshGeometryError,
              exc_jax=jmesh.MeshGeometryError):
    with pytest.raises(exc_port) as got:
        port_call()
    with pytest.raises(exc_jax) as want:
        jax_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


# ----------------------------------------------------------------- geometry
class TestMeshGeometry:
    """Every bad geometry fails typed and loud, with JAX's message."""

    def test_model_mesh_validation(self):
        devs = [CPU] * 8
        jdevs = jax.devices()
        assert len(jdevs) == 8
        for tp, match in ((0, ">= 1"), (9, "exceeds"), (3, "not divisible")):
            msg = _messages(lambda: model_mesh(tp, devices=devs),
                            lambda: jmesh.model_mesh(tp, devices=jdevs))
            assert match in msg
        m = model_mesh(2, devices=devs)
        assert m.shape == {MODEL_AXIS: 2} and m.axis_names == (MODEL_AXIS,)
        assert m.size == 2 and m.flat == [CPU, CPU]
        dm = data_model_mesh(2, 4, devices=devs)
        assert dm.shape == {"data": 2, MODEL_AXIS: 4}
        _messages(lambda: data_model_mesh(3, 4, devices=devs),
                  lambda: jmesh.data_model_mesh(3, 4, devices=jdevs))
        assert data_mesh(4, devices=devs).shape == {"data": 4}
        _messages(lambda: data_mesh(9, devices=devs),
                  lambda: jmesh.data_mesh(9, devices=jdevs),
                  ValueError, ValueError)

    def test_no_card_never_reuses_one(self):
        """``devices=None`` counts the CUDA devices: with none, a tp mesh
        raises instead of reusing the host or one card."""
        n = torch.cuda.device_count()
        with pytest.raises(MeshGeometryError, match="exceeds"):
            model_mesh(n + 1)

    def test_device_groups_disjoint_and_validated(self):
        named = [torch.device("cuda", i) for i in range(8)]
        groups = device_groups(2, 2, devices=named)
        assert [len(g) for g in groups] == [2, 2]
        assert len({d for g in groups for d in g}) == 4  # disjoint
        assert groups == [named[:2], named[2:4]]
        assert [len(g) for g in jfleet.device_groups(2, 2)] == [2, 2]
        with pytest.raises(MeshGeometryError):
            device_groups(0, 2, devices=named)
        _messages(lambda: device_groups(3, 4, devices=named),
                  lambda: jfleet.device_groups(3, 4, devices=jax.devices()))

    def test_heads_not_divisible_by_tp(self):
        kw = dict(KW, n_heads=2)
        tnet = TransformerLM(**kw).init(device="cpu")
        jnet = JaxTransformerLM(seed=7, **kw).init()
        _messages(lambda: GenerationServer(tnet, V, slots=2,
                                           mesh=cpu_mesh(4)),
                  lambda: JaxGenerationServer(jnet, V, slots=2, tp=4))

    def test_tp_disagrees_with_mesh(self, nets):
        jnet, tnet = nets
        msg = _messages(
            lambda: GenerationServer(tnet, V, slots=2, mesh=cpu_mesh(2),
                                     tp=4),
            lambda: JaxGenerationServer(jnet, V, slots=2,
                                        mesh=jmesh.model_mesh(2), tp=4))
        assert "disagrees" in msg

    def test_mesh_without_model_axis(self, nets):
        from jax.sharding import Mesh as JaxMesh
        jnet, tnet = nets
        msg = _messages(
            lambda: GenerationServer(tnet, V, slots=2,
                                     mesh=cpu_mesh(2, ("data",))),
            lambda: JaxGenerationServer(
                jnet, V, slots=2,
                mesh=JaxMesh(np.array(jax.devices()[:2]), ("data",))))
        assert "model" in msg

    def test_device_disagreeing_with_the_mesh_raises(self, nets):
        _, tnet = nets
        with pytest.raises(MeshGeometryError, match="disagrees"):
            GenerationServer(tnet, V, slots=2, device="meta",
                             mesh=cpu_mesh(2))


# ------------------------------------------------------------------- parity
class TestMeshParity:
    """Sharding the pool by heads changes where the KV lives, never a
    token: the only collective is the exact all-gather of disjoint
    per-head contexts before Wo."""

    def test_tp2_greedy_and_sampled_bitexact(self, nets, refs, jax_streams):
        _, tnet = nets
        got = _serve(GenerationServer, tnet, (GREEDY, SAMPLED),
                     mesh=cpu_mesh(2))
        assert got == [refs["greedy"], refs["sampled"]]
        assert got == list(jax_streams[2])

    def test_tp4_greedy_bitexact(self, nets, refs, jax_streams):
        _, tnet = nets
        got, = _serve(GenerationServer, tnet, (GREEDY,), mesh=cpu_mesh(4))
        assert got == refs["greedy"] == jax_streams[4][0]

    def test_tp_int8_parity_with_single_device_int8(self, nets, refs):
        _, tnet = nets
        got, = _serve(GenerationServer, tnet, (GREEDY,), mesh=cpu_mesh(2),
                      kv_dtype="int8")
        assert got == refs["int8"]

    def test_tp2_pallas_backend_bitexact(self, nets, refs):
        """The paged kernel's wrapper sees only its shard's heads (on CPU
        tensors it computes K2's plain version), told the model's full
        head count for its split rule: streams equal tp=1's."""
        _, tnet = nets
        got, = _serve(GenerationServer, tnet, (GREEDY,), mesh=cpu_mesh(2),
                      paged_attention="pallas")
        assert got == refs["greedy"]

    def test_tp2_speculative_equals_tp1(self, nets, refs):
        """Speculative decode on a tp=2 server (the target verifies on the
        sharded pool, the draft keeps its dense cache on the mesh's first
        device): the greedy and sampled streams are tp=1's."""
        _, tnet = nets
        got = _serve(GenerationServer, tnet, (GREEDY, SAMPLED),
                     mesh=cpu_mesh(2), draft_net=tnet, spec_k=3)
        assert got == [refs["greedy"], refs["sampled"]]

    def test_shard_local_reads_concatenate_to_the_full_read(self):
        """K2's wrapper on each head shard of a pool, with ``split_heads``
        the full count, concatenates to the whole pool's read (exact)."""
        g = torch.Generator().manual_seed(0)
        B, H, T, d, P, ps, NP = 2, 4, 6, 8, 9, 4, 4
        q = torch.randn(B, H, T, d, generator=g)
        kp = torch.randn(P, H, ps, d, generator=g)
        vp = torch.randn(P, H, ps, d, generator=g)
        bt = torch.randint(1, P, (B, NP), generator=g, dtype=torch.int32)
        pos = torch.tensor([3, 9], dtype=torch.int32)
        whole = ppa.paged_attention(q, kp, vp, bt, pos)
        parts = [ppa.paged_attention(q[:, h:h + 2], kp[:, h:h + 2],
                                     vp[:, h:h + 2], bt, pos, split_heads=H)
                 for h in (0, 2)]
        assert torch.equal(all_gather(parts, CPU, dim=1), whole)

    def test_sharded_pools_hold_their_heads(self, nets):
        """Each shard owns ``[pages, H/tp, ps, d]`` on its mesh entry and
        the admission bytes count every shard."""
        _, tnet = nets
        with serving(GenerationServer, tnet, mesh=cpu_mesh(4),
                     kv_dtype="int8") as srv:
            leaf = next(iter(srv._pool.values()))
            assert set(leaf) == {"kpages", "vpages", "kscales", "vscales"}
            assert [tuple(a.shape) for a in leaf["kpages"]] == \
                [(srv.pages_total, 1, 4, 4)] * 4
            assert len({a.data_ptr() for a in leaf["kpages"]}) == 4
            assert srv.stats()["pages"]["bytes_per_token"] == \
                srv._page_token_bytes

    def test_one_device_pool_is_one_shard(self, nets):
        """Without a mesh the pool takes the same layout: each leaf a list
        of one ``[pages, H, ps, d]`` shard on the server's device."""
        _, tnet = nets
        with serving(GenerationServer, tnet, device="cpu") as srv:
            leaf = next(iter(srv._pool.values()))
            assert [tuple(a.shape) for a in leaf["kpages"]] == \
                [(srv.pages_total, 4, 4, 4)]
            assert leaf["kpages"][0].device == srv.device


# ------------------------------------------------------------------ handoff
def _snap_at(cls, net, spec, **kw):
    """(completed tokens, the last snapshot published mid-stream)."""
    with serving(cls, net, snapshot_every=4, steps_per_dispatch=2,
                 **kw) as srv:
        fut = _submit(srv, spec)
        out = np.asarray(fut.result(timeout=120)).tolist()
    snap = getattr(fut, "_kv_snapshot", None)
    assert snap is not None and 0 < snap.count < spec[1]
    return out, snap


def _adopt(cls, net, snap, **kw):
    with serving(cls, net, **kw) as dst:
        res = dst.adopt_request(snap).result(timeout=120)
        st = dst.stats()["handoff"]
    assert st["resumes"] == 1 and st["fallbacks"] == 0
    return np.asarray(res).tolist()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
class TestCrossTPHandoff:
    """Wire v3 both ways: export gathers the shards into the canonical
    layout (header ``shards=tp``), adopt re-shards to the local tp."""

    def test_jax_tp2_export_adopts_in_the_port_at_tp4_and_tp1(self, nets,
                                                              kv_dtype):
        jnet, tnet = nets
        out, jsnap = _snap_at(JaxGenerationServer, jnet, GREEDY, tp=2,
                              kv_dtype=kv_dtype)
        assert jsnap.shards == 2 and jsnap.head_layout == "canonical"
        snap = KVSnapshot.from_bytes(jsnap.to_bytes())
        for kw in (dict(mesh=cpu_mesh(4)), dict(device="cpu")):
            assert _adopt(GenerationServer, tnet, snap, kv_dtype=kv_dtype,
                          **kw) == out

    def test_port_tp2_export_adopts_in_jax_at_tp4(self, nets, refs,
                                                  kv_dtype):
        jnet, tnet = nets
        specs = (GREEDY, SAMPLED) if kv_dtype is None else (GREEDY,)
        snaps = []
        for spec in specs:
            out, snap = _snap_at(GenerationServer, tnet, spec,
                                 mesh=cpu_mesh(2), kv_dtype=kv_dtype)
            assert snap.version == 3 and snap.shards == 2
            assert snap.head_layout == "canonical"
            blob = snap.to_bytes()
            assert KVSnapshot.from_bytes(blob).to_bytes() == blob
            snaps.append((out, JaxKVSnapshot.from_bytes(blob)))
        with serving(JaxGenerationServer, jnet, tp=4,
                     kv_dtype=kv_dtype) as dst:
            for out, jsnap in snaps:
                res = dst.adopt_request(jsnap).result(timeout=120)
                assert np.asarray(res).tolist() == out
            st = dst.stats()["handoff"]
        assert st["resumes"] == len(snaps) and st["fallbacks"] == 0
        want = refs["greedy"] if kv_dtype is None else refs["int8"]
        assert snaps[0][0] == want


# ----------------------------------------------------------- replica groups
def _wait_replica_midstream(fl, rid, min_snapshots=2, timeout=60.0):
    t_end = time.monotonic() + timeout
    while True:
        srv = fl.stats()["replicas"][rid]["server"] or {}
        if (srv.get("active_slots", 0) >= 1
                and srv.get("handoff", {}).get("snapshots", 0)
                >= min_snapshots):
            return
        assert time.monotonic() < t_end, "replica never reached mid-stream"
        time.sleep(0.005)


def _group_fleet(tnet, groups, specs, kill):
    """A fleet of tp=2 replica groups serving ``specs``; with ``kill`` the
    first group dies mid-stream. Returns (streams, fleet stats)."""
    def factory(rid):
        mesh = Mesh(groups[rid % len(groups)], (MODEL_AXIS,))
        chaos = ChaosPolicy(seed=1000 + rid, stall_rate=1.0, stall_s=0.005)
        return GenerationServer(tnet, V, slots=4, page_size=4,
                                snapshot_every=1, steps_per_dispatch=1,
                                mesh=mesh, chaos=chaos)

    fl = ReplicaFleet(factory, replicas=len(groups), max_pending=64,
                      restart_backoff_s=0.02)
    try:
        futs = []
        for p, steps, temp, top_k, seed in specs:
            t_end = time.monotonic() + 30.0
            while True:
                try:
                    futs.append(fl.submit(p, steps, temperature=temp,
                                          top_k=top_k, seed=seed,
                                          deadline_s=120.0))
                    break
                except ResilienceError:
                    assert time.monotonic() < t_end
                    time.sleep(0.02)
        if kill:
            _wait_replica_midstream(fl, 0)
            fl.kill_replica(0)
        outs = [np.asarray(f.result(timeout=120)).tolist() for f in futs]
        return outs, fl.stats()
    finally:
        fl.close()


def _fleet_specs(n):
    rng = np.random.default_rng(31)
    specs = []
    for i in range(n):
        p = rng.integers(1, V, size=3 + i % 3).astype(np.int64)
        specs.append((p, 8, 0.0, 0, 0) if i % 2 == 0
                     else (p, 8, 0.9, 5, 3000 + i))
    return specs


class TestMeshFleet:
    def test_replica_groups_midstream_kill_zero_lost(self, nets):
        """Two tp=2 replica groups on disjoint mesh entries behind one
        fleet; a group killed mid-stream loses no future, and every stream
        is the one-device server's."""
        _, tnet = nets
        specs = _fleet_specs(6)
        want = _serve(GenerationServer, tnet, specs, device="cpu")
        groups = device_groups(2, 2, devices=[CPU] * 4)
        outs, st = _group_fleet(tnet, groups, specs, kill=True)
        assert outs == want
        assert st["completed"] == len(specs)
        assert st["failed"] == 0 and st["expired"] == 0
        assert st["deaths"] >= 1


# ---------------------------------------------------------- restore-on-close
class TestRestoreOnClose:
    def test_close_restores_the_nets_layer_knobs(self, nets, refs):
        """A mesh server pushes its ``paged_attention`` knob while live
        and restores it on close; the net then serves one-device f32
        exactly as before."""
        _, tnet = nets
        attn = [lyr for _n, lyr in tnet._stream_layers()
                if hasattr(lyr, "init_paged_carry")]
        assert attn
        with serving(GenerationServer, tnet, mesh=cpu_mesh(2),
                     paged_attention="xla") as srv:
            assert srv._tp == 2
            assert np.asarray(_submit(srv, GREEDY).result(
                timeout=120)).tolist() == refs["greedy"]
            assert all(lyr.paged_attention == "xla" for lyr in attn)
        assert all(lyr.paged_attention == "auto" for lyr in attn)
        got, = _serve(GenerationServer, tnet, (GREEDY,), device="cpu")
        assert got == refs["greedy"]
