"""Port parity: ``ReplicaFleet`` (the port's ``parallel/fleet.py``) over the
port's ``GenerationServer`` and ``ParallelInference`` replicas, on the CPU:
the cases of ``tests/test_fleet.py`` and the fleet classes of
``tests/test_disagg.py`` (``TestTieredFleet``, ``TestTierChaos``,
``TestChaosPinning``).

The replicas serve the port's twin of the JAX ``TransformerLM`` (d_model
16, 1 block, V = 17, the JAX net's weights through ``params_from_jax``), and
every stream must equal the JAX package's serial ``greedy_generate`` /
``sample_generate`` reference token for token: across routing, shedding,
replica kills (a re-dispatched sampled request regenerates the same tokens
on another replica because token i's key is ``fold_in(PRNGKey(seed), i)``),
hedging, retirement and the prefill/decode tiers with their degraded mode.
``stats()`` keys and the ``fleet_*`` families of a scrape equal the JAX
fleet's; the spawn-failure backoff walks JAX's sequence. Over
``ParallelInference`` replicas each row equals the port net's own forward
of that row bit for bit and JAX's within 1e-5 (the JAX test of that case
asserts atol = 0 across bucket sizes and fails on the reference, ROADMAP
C6).

The 200-request chaos soak runs in tier-1 (a few seconds on the CPU).
Every ``result()`` carries a timeout and every fleet is closed in a
``finally``.
"""

import time
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.metrics.exposition import (  # noqa: E402
    render_text as jax_render)
from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.parallel import fleet as jfleet  # noqa: E402
from deeplearning4j_tpu.parallel import resilience as jres  # noqa: E402
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_torch.metrics.exposition import render_text  # noqa
from deeplearning4j_torch.parallel import fleet as tfleet  # noqa: E402
from deeplearning4j_torch.parallel.fleet import (  # noqa: E402
    READY, RETIRED, ReplicaFleet, device_groups)
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.parallel.inference import (  # noqa: E402
    ParallelInference)
from deeplearning4j_torch.parallel.mesh import MeshGeometryError  # noqa
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    ChaosPolicy, ReplicaKilled, ReplicaUnavailable, ResilienceError,
    ServerOverloaded)
from tests.test_torch_inference import features, mln_pair  # noqa: E402
from tests.test_torch_speculative import V, jax_pair  # noqa: E402

pytestmark = pytest.mark.torch_port

GREEDY = (np.array([1, 2, 3, 4], np.int64), 12, 0.0, 0, 0)
SAMPLED = (np.array([1, 2, 3, 4], np.int64), 12, 0.9, 5, 77)


@pytest.fixture(scope="module")
def lm():
    return jax_pair(3, 16)


def _gen_factory(tnet, **chaos_kw):
    """Replicas with their own seeded fault injector (seed from the rid)."""
    def factory(rid):
        chaos = (ChaosPolicy(seed=1000 + rid, **chaos_kw)
                 if chaos_kw else None)
        return GenerationServer(tnet, V, slots=4, chaos=chaos, device="cpu")
    return factory


def _tier_factory(tnet, roles, chaos_by_rid=None, **gen_kw):
    kw = dict(slots=2, page_size=4, steps_per_dispatch=1)
    kw.update(gen_kw)

    def factory(rid):
        extra = {}
        if chaos_by_rid and rid in chaos_by_rid:
            extra["chaos"] = chaos_by_rid[rid]
        return GenerationServer(tnet, V, role=roles[rid], device="cpu",
                                **kw, **extra)
    return factory


@contextmanager
def fleet_of(factory, replicas=2, **kw):
    fl = ReplicaFleet(factory, replicas=replicas, **kw)
    try:
        yield fl
    finally:
        fl.close()


def _mixed_specs(n, rng, shapes=((3, 4), (5, 5), (4, 6))):
    specs = []
    for i in range(n):
        plen, steps = shapes[i % len(shapes)]
        p = rng.integers(1, V, size=plen).astype(np.int64)
        if i % 2 == 0:
            specs.append((p, steps, 0.0, 0, 0))
        else:
            specs.append((p, steps, 0.9, 5, 2000 + i))
    return specs


def _serial_refs(lm, specs):
    """The JAX package's serial references."""
    jnet = lm[0]
    refs = []
    for p, steps, temp, top_k, seed in specs:
        if temp == 0.0:
            refs.append(jzoo.greedy_generate(jnet, p[None], steps, V)[0])
        else:
            refs.append(jzoo.sample_generate(jnet, p[None], steps, V,
                                             temperature=temp, top_k=top_k,
                                             seed=seed)[0])
    return [np.asarray(r).tolist() for r in refs]


def _submit_with_backoff(fleet, spec, deadline_s=240.0, budget_s=60.0):
    """Client-side 429/503 handling: a typed shed at submit means back off
    and resubmit."""
    p, steps, temp, top_k, seed = spec
    t_end = time.monotonic() + budget_s
    while True:
        try:
            return fleet.submit(p, steps, temperature=temp, top_k=top_k,
                                seed=seed, deadline_s=deadline_s)
        except ResilienceError:
            if time.monotonic() > t_end:
                raise
            time.sleep(0.02)


def _assert_streams(futs, refs, timeout=240):
    for fut, ref in zip(futs, refs):
        assert np.asarray(fut.result(timeout=timeout)).tolist() == ref


def _assert_zero_lost(st):
    assert st["submitted"] == (st["completed"] + st["failed"]
                               + st["expired"] + st["rejected_submits"]), st
    assert st["inflight"] == 0 and st["parked"] == 0


def _wait_until(pred, timeout=60.0, step=0.01):
    limit = time.monotonic() + timeout
    while time.monotonic() < limit:
        if pred():
            return True
        time.sleep(step)
    return pred()


# ------------------------------------------------------------------ routing
def test_routes_spread_and_streams_equal_jax(lm):
    specs = _mixed_specs(12, np.random.default_rng(5))
    refs = _serial_refs(lm, specs)
    with fleet_of(_gen_factory(lm[1])) as fl:
        futs = [fl.submit(p, s, temperature=t, top_k=k, seed=sd,
                          deadline_s=120.0) for p, s, t, k, sd in specs]
        _assert_streams(futs, refs)
        st = fl.stats()
    assert st["completed"] == len(specs)
    assert st["failed"] == 0 and st["expired"] == 0
    assert all(r["dispatched"] > 0 for r in st["replicas"])


def test_sick_replica_sheds_into_healthy_one(lm):
    """Replica 0 fails every dispatch: its breaker trips, its requests
    re-dispatch to the survivor, and every stream is still JAX's."""
    def factory(rid):
        chaos = ChaosPolicy(seed=9, hard_rate=1.0) if rid == 0 else None
        return GenerationServer(lm[1], V, slots=4, chaos=chaos,
                                device="cpu")

    specs = _mixed_specs(8, np.random.default_rng(6))
    refs = _serial_refs(lm, specs)
    with fleet_of(factory) as fl:
        futs = [_submit_with_backoff(fl, sp) for sp in specs]
        _assert_streams(futs, refs)
        st = fl.stats()
    assert st["replicas"][0]["failed"] > 0
    assert st["redispatched"] > 0 and st["completed"] == len(specs)


def test_submit_sheds_typed_when_everything_is_down(lm):
    with fleet_of(_gen_factory(lm[1]), restart=False) as fl:
        fl.kill_replica(0)
        fl.kill_replica(1)
        assert _wait_until(lambda: all(
            r["state"] != READY for r in fl.stats()["replicas"]))
        with pytest.raises(ReplicaUnavailable):
            fl.submit(np.array([1, 2], np.int64), 2)
        assert fl.kill_replica(0) is False        # already dead


def test_validation_errors_propagate_sync(lm):
    with fleet_of(_gen_factory(lm[1])) as fl:
        with pytest.raises(ValueError):
            fl.submit(np.array([1, 2], np.int64), 2, deadline_s=-1.0)
        with pytest.raises(ValueError):
            fl.submit(np.array([], np.int64), 2)
        with pytest.raises(ServerOverloaded):
            fl.submit(np.array([1, 2], np.int64), 10_000)
        with pytest.raises(ValueError, match="tier"):
            fl.submit(np.array([1, 2], np.int64), 2, tier="knn")
        st = fl.stats()
    assert st["inflight"] == 0 and fl.admission.pending == 0
    assert st["rejected_submits"] == 2 and st["failed"] == 0


def test_roles_validated_as_jax():
    """Role lists are validated as JAX validates them, ``knn``/
    ``generate`` included (the RAG tiers: ``EmbeddingIndex`` and
    ``GenerationServer`` replicas behind ``parallel/rag.py``)."""
    cases = [(("prefill", "bogus"), 2), (("prefill",), 2),
             (("decode", "decode"), 2), (("prefill", "prefill"), 2),
             (("knn", "generate"), 2)]

    class _Dud:
        def __init__(self, role):
            self.role = role

        def close(self, timeout=0.0):
            pass

    for roles, n in cases:
        got = []
        for mod in (jfleet, tfleet):
            try:
                fl = mod.ReplicaFleet(lambda rid: _Dud(roles[rid]),
                                      replicas=n, roles=roles)
                got.append("ok")
                fl.close(timeout=1.0)
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1], roles


# ---------------------------------------------------------------- lifecycle
def test_kill_restarts_with_counters(lm):
    """Replica 0 killed mid-generation: its requests (greedy and sampled)
    re-dispatch and finish JAX's streams; the replica restarts."""
    specs = _mixed_specs(10, np.random.default_rng(7))
    refs = _serial_refs(lm, specs)
    with fleet_of(_gen_factory(lm[1]), restart_backoff_s=0.02) as fl:
        futs = [fl.submit(p, s, temperature=t, top_k=k, seed=sd,
                          deadline_s=180.0) for p, s, t, k, sd in specs]
        time.sleep(0.05)
        assert fl.kill_replica(0)
        _assert_streams(futs, refs)
        assert _wait_until(lambda: fl.stats()["replicas"][0]["state"] == READY
                           and fl.stats()["replicas"][0]["restarts"] >= 1)
        st = fl.stats()
    assert st["deaths"] >= 1 and st["restarts"] >= 1
    assert st["replicas"][0]["generation"] >= 1
    _assert_zero_lost(st)


def test_killed_replica_is_released_after_respawn(lm):
    """A killed replica's server (and so its KV page pool) is unreachable
    once the monitor has swapped in its respawn: nothing of the fleet, the
    supervisor or a finished request keeps it alive."""
    import gc
    import weakref

    with fleet_of(_gen_factory(lm[1]), restart_backoff_s=0.02) as fl:
        fl.submit(np.array([1, 2, 3], np.int64), 3).result(timeout=60)
        old = weakref.ref(fl._replicas[0].server)
        assert fl.kill_replica(0)
        assert _wait_until(lambda: fl.stats()["replicas"][0]["state"] == READY
                           and fl.stats()["replicas"][0]["restarts"] >= 1)
        assert fl.submit(np.array([4, 5], np.int64), 2).result(
            timeout=60) is not None
        gc.collect()
        assert old() is None


def test_retire_drains_for_good(lm):
    with fleet_of(_gen_factory(lm[1])) as fl:
        assert fl.retire_replica(0)
        assert fl.retire_replica(0) is False
        assert fl.stats()["replicas"][0]["state"] == RETIRED
        out = fl.submit(np.array([1, 2, 3], np.int64), 3).result(timeout=120)
        assert len(out) == 3
        st = fl.stats()
    assert st["replicas"][0]["state"] == RETIRED
    assert st["replicas"][1]["dispatched"] >= 1


def test_retire_with_migration_resumes_elsewhere(lm):
    """``retire_replica(migrate=True)`` moves live requests off as
    snapshots; the survivor adopts them and finishes JAX's streams."""
    specs = [(np.array([1, 2, 3], np.int64), 12, 0.0, 0, 0),
             (np.array([4, 5, 6], np.int64), 12, 0.9, 5, 31)]
    refs = _serial_refs(lm, specs)
    with fleet_of(_gen_factory(lm[1])) as fl:
        futs = [fl.submit(p, s, temperature=t, top_k=k, seed=sd)
                for p, s, t, k, sd in specs]
        time.sleep(0.02)
        assert fl.retire_replica(0, timeout=30, migrate=True)
        _assert_streams(futs, refs)
        st = fl.stats()
    _assert_zero_lost(st)


def test_close_never_leaves_hung_futures(lm):
    fl = ReplicaFleet(_gen_factory(lm[1]), replicas=2)
    futs = [fl.submit(np.array([1, 2, 3], np.int64), 4) for _ in range(6)]
    fl.close(timeout=120.0)
    assert all(f.done() for f in futs)
    fl.close()
    with pytest.raises(RuntimeError, match="closed"):
        fl.submit(np.array([1, 2, 3], np.int64), 4)


class _Dud:
    """A replica that refuses every request."""

    def close(self, timeout=0.0):
        pass

    def submit(self, *a, **k):
        raise ReplicaKilled("dud replica")

    def drain(self, timeout=None):
        return True

    def stats(self):
        return {}


def _spawn_backoffs(mod):
    """The backoff each respawn attempt saw: spawns 2 and 3 fail, 4 works."""
    seen, holder = [], []

    def factory(rid):
        if holder:
            seen.append(holder[0]._replicas[0].backoff_s)
        if len(seen) in (1, 2):
            raise RuntimeError("spawn flake")
        return _Dud()

    fl = mod.ReplicaFleet(factory, replicas=1, restart_backoff_s=0.02,
                          restart_backoff_cap_s=0.05)
    holder.append(fl)
    try:
        fl.kill_replica(0)
        assert _wait_until(lambda: fl.stats()["replicas"][0]["state"]
                           == "ready"
                           and fl.stats()["replicas"][0]["restarts"] >= 1,
                           timeout=30)
        rep = fl.stats()["replicas"][0]
        return seen, rep["spawn_failures"], rep["restarts"], rep["state"]
    finally:
        fl.close()


def test_spawn_failure_backoff_sequence_equals_jax():
    """Spawn failures back off exponentially to the cap, as JAX's do."""
    got = _spawn_backoffs(tfleet)
    assert got == _spawn_backoffs(jfleet)
    assert got == ([0.02, 0.04, 0.05], 2, 1, "ready")


def test_device_groups():
    """``device_groups`` carves disjoint groups (single-card, and of
    ``tp`` entries for tensor-parallel replica groups, as JAX's); short
    pools and bad geometry raise ``MeshGeometryError``."""
    devs = [torch.device("cpu")] * 3
    assert device_groups(3, 1, devices=devs) == [[d] for d in devs]
    with pytest.raises(MeshGeometryError, match="needs 4 devices"):
        device_groups(4, 1, devices=devs)
    with pytest.raises(MeshGeometryError):
        device_groups(0, 1, devices=devs)
    named = [torch.device("cuda", i) for i in range(4)]
    assert device_groups(2, 2, devices=named) == [named[:2], named[2:]]
    assert device_groups(1, 2, devices=devs) == [devs[:2]]
    assert issubclass(MeshGeometryError, ValueError)


# ------------------------------------------------------------------ hedging
def test_straggler_hedged_first_result_wins(lm):
    """Replica 0 stalls every dispatch; hedged duplicates on the healthy
    replica win, the losers are cancelled, the streams are JAX's."""
    def factory(rid):
        chaos = (ChaosPolicy(seed=3, stall_rate=1.0, stall_s=0.25)
                 if rid == 0 else None)
        return GenerationServer(lm[1], V, slots=4, chaos=chaos,
                                device="cpu")

    specs = _mixed_specs(6, np.random.default_rng(8))
    refs = _serial_refs(lm, specs)
    with fleet_of(factory, hedge_after_s=0.15, max_hedges=1) as fl:
        futs = [fl.submit(p, s, temperature=t, top_k=k, seed=sd,
                          deadline_s=180.0) for p, s, t, k, sd in specs]
        _assert_streams(futs, refs)
        st = fl.stats()
    assert st["completed"] == len(specs)
    assert st["hedged"] >= 1 and st["losers_cancelled"] >= 1


# ------------------------------------------- over ParallelInference replicas
def test_failover_rows_over_parallel_inference():
    """Rows through a fleet of two ParallelInference replicas, one killed
    mid-run: every row bit for bit the port net's own forward of that row
    (one-row buckets, ``max_batch=1``) and within 1e-5 of JAX's."""
    jnet, tnet = mln_pair()
    x = features(24, seed=11)
    jref = np.asarray(jnet.output(x))
    own = np.concatenate([tnet.output(x[i:i + 1]).numpy()
                          for i in range(24)])

    def factory(rid):
        chaos = ChaosPolicy(seed=50 + rid, stall_rate=0.1, stall_s=0.01)
        return ParallelInference(tnet, max_batch=1, max_wait_ms=1.0,
                                 chaos=chaos, device="cpu")

    with fleet_of(factory, restart_backoff_s=0.02) as fl:
        futs = [fl.submit(x[i:i + 1], deadline_s=60.0) for i in range(12)]
        fl.kill_replica(0)
        futs += [fl.submit(x[i:i + 1], deadline_s=60.0)
                 for i in range(12, 24)]
        rows = np.concatenate([np.asarray(f.result(timeout=120))
                               for f in futs])
        st = fl.stats()
    np.testing.assert_array_equal(rows, own)
    np.testing.assert_allclose(rows, jref, rtol=0, atol=1e-5)
    assert st["completed"] == 24 and st["deaths"] >= 1


# ------------------------------------------------- stats keys and families
def _families(text):
    return sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE")})


def test_stats_keys_and_families_equal_jax(lm):
    """``stats()`` (a replica block included) has the JAX fleet's keys in
    its order, tiered too; a scrape of the fleet's registry shows JAX's
    ``fleet_*`` families."""
    jnet, tnet = lm
    got = {}
    for which in ("jax", "port"):
        for roles in (None, ("prefill", "decode")):
            if which == "jax":
                def factory(rid, roles=roles):
                    return JaxGenerationServer(
                        jnet, V, slots=2, paged_attention="xla",
                        role=roles[rid] if roles else "unified")
                fl = jfleet.ReplicaFleet(factory, replicas=2, roles=roles)
                render = jax_render
            else:
                def factory(rid, roles=roles):
                    return GenerationServer(
                        tnet, V, slots=2, device="cpu",
                        role=roles[rid] if roles else "unified")
                fl = ReplicaFleet(factory, replicas=2, roles=roles)
                render = render_text
            try:
                st = fl.stats()
                text = render([({}, fl.metrics)])
            finally:
                fl.close()
            got[which, roles] = (list(st), list(st["replicas"][0]),
                                 list(st.get("tiers", {})),
                                 _families(text))
    for roles in (None, ("prefill", "decode")):
        assert got["port", roles] == got["jax", roles]
    assert "fleet_ttft_ms" in got["port", None][3]


# ------------------------------------------------------------ tiered fleet
def test_tiered_streams_ledger_and_slos(lm):
    """``TestTieredFleet``: every stream crosses prefill → decode and
    equals JAX's serial reference; TTFT and inter-token latency land in
    separate histograms; the per-tier slot levers move independently."""
    specs = _mixed_specs(8, np.random.default_rng(42))
    refs = _serial_refs(lm, specs)
    roles = ("prefill", "decode")
    with fleet_of(_tier_factory(lm[1], roles), 2, roles=roles) as fl:
        futs = [_submit_with_backoff(fl, sp) for sp in specs]
        _assert_streams(futs, refs)
        st = fl.stats()
        assert st["tier_handoffs"] >= len(specs)
        assert st["degraded_mode"] is False
        assert st["tiers"]["prefill"]["replicas"] == 1
        assert st["tiers"]["decode"]["replicas"] == 1
        assert st["completed"] == len(specs)
        _assert_zero_lost(st)
        assert fl.ttft_hist.count == len(specs) == fl.itl_hist.count
        assert fl.ttft_hist.sum > 0 and fl.itl_hist.sum > 0
        assert fl.set_tier_active_slots("decode", 1) == 1
        assert fl.tier_stats("decode")["active_slots"] == 1
        assert fl.tier_stats("prefill")["active_slots"] == 2
        assert fl.set_tier_active_slots("decode", 2) == 2
        assert fl.set_tier_active_slots("unified", 2) == 0


def test_int8_tiered_matches_unified(lm):
    specs = [GREEDY, SAMPLED]
    uni = GenerationServer(lm[1], V, slots=2, page_size=4, kv_dtype="int8",
                           device="cpu")
    try:
        refs = [uni.submit(p, s, temperature=t, top_k=k,
                           seed=sd).result(timeout=120).tolist()
                for p, s, t, k, sd in specs]
    finally:
        uni.close()
    roles = ("prefill", "decode")
    with fleet_of(_tier_factory(lm[1], roles, kv_dtype="int8"), 2,
                  roles=roles) as fl:
        _assert_streams([_submit_with_backoff(fl, sp) for sp in specs], refs)
        _assert_zero_lost(fl.stats())


def test_decode_tier_dark_degraded_and_recovery(lm):
    """The only decode replica killed: degraded mode serves co-located on
    the prefill tier (JAX's streams), then clears when the tier heals."""
    ref = _serial_refs(lm, [GREEDY])
    roles = ("prefill", "decode")
    with fleet_of(_tier_factory(lm[1], roles), 2, roles=roles,
                  restart_backoff_s=3.0) as fl:
        assert fl.kill_replica(1)
        futs = [_submit_with_backoff(fl, GREEDY) for _ in range(3)]
        _assert_streams(futs, ref * 3)
        st = fl.stats()
        assert st["degraded_mode"] is True
        assert st["degraded_submits"] >= 3
        assert _wait_until(lambda: not fl.stats()["degraded_mode"],
                           timeout=90)
        before = fl.stats()["tier_handoffs"]
        _assert_streams([_submit_with_backoff(fl, GREEDY)], ref)
        st = fl.stats()
        assert st["tier_handoffs"] > before
        _assert_zero_lost(st)


def test_midhandoff_prefill_and_decode_kills(lm):
    """A prefill replica killed with requests in flight, then a decode
    replica killed mid-stream (snapshots every 4 tokens): every request
    finishes JAX's stream, nothing lost."""
    specs = _mixed_specs(6, np.random.default_rng(7))
    refs = _serial_refs(lm, specs)
    roles = ("prefill", "prefill", "decode")
    with fleet_of(_tier_factory(lm[1], roles), 3, roles=roles) as fl:
        futs = [_submit_with_backoff(fl, sp) for sp in specs]
        fl.kill_replica(0)
        _assert_streams(futs, refs)
        st = fl.stats()
        assert st["completed"] == len(specs)
        _assert_zero_lost(st)
    specs = _mixed_specs(6, np.random.default_rng(11),
                         shapes=((3, 12), (4, 12), (3, 13)))
    refs = _serial_refs(lm, specs)
    roles = ("prefill", "decode", "decode")
    with fleet_of(_tier_factory(lm[1], roles, snapshot_every=4), 3,
                  roles=roles) as fl:
        futs = [_submit_with_backoff(fl, sp) for sp in specs]
        victim = None
        t_end = time.monotonic() + 90.0
        while victim is None and time.monotonic() < t_end:
            for blk in fl.stats()["replicas"]:
                srv = blk["server"] or {}
                if (blk["role"] == "decode" and blk["state"] == "ready"
                        and srv.get("active_slots", 0) >= 1):
                    victim = blk["rid"]
                    break
            else:
                time.sleep(0.005)
        if victim is not None:
            fl.kill_replica(victim)
        _assert_streams(futs, refs)
        st = fl.stats()
        assert st["completed"] == len(specs)
        _assert_zero_lost(st)


@pytest.mark.parametrize("mode", ["corrupt", "truncate"])
def test_faulty_transfer_token0_fallback(lm, mode):
    """A corrupted or truncated tier transfer is dropped at adoption and
    the request regenerates from token 0 on the decode tier: JAX's stream,
    a counted fallback, nothing lost."""
    chaos = ChaosPolicy(seed=5, snapshot_corrupt_rate=1.0) \
        if mode == "corrupt" else ChaosPolicy(seed=6,
                                              handoff_truncate_rate=1.0)
    specs = [GREEDY, SAMPLED]
    refs = _serial_refs(lm, specs)
    roles = ("prefill", "decode")
    with fleet_of(_tier_factory(lm[1], roles, chaos_by_rid={0: chaos}), 2,
                  roles=roles) as fl:
        _assert_streams([_submit_with_backoff(fl, sp) for sp in specs], refs)
        st = fl.stats()
    assert st["handoff_fallbacks"] >= len(specs)
    assert st["completed"] == len(specs) and st["failed"] == 0
    _assert_zero_lost(st)


def test_dropped_transfer_reprefills_on_sibling(lm):
    specs = [GREEDY, SAMPLED, (np.array([2, 5, 1], np.int64), 10, 0.0, 0, 0)]
    refs = _serial_refs(lm, specs)
    chaos = ChaosPolicy(seed=8, handoff_drop_rate=1.0)
    roles = ("prefill", "prefill", "decode")
    with fleet_of(_tier_factory(lm[1], roles, chaos_by_rid={0: chaos}), 3,
                  roles=roles) as fl:
        _assert_streams([_submit_with_backoff(fl, sp) for sp in specs], refs)
        st = fl.stats()
    assert st["completed"] == len(specs) and st["failed"] == 0
    if chaos.injected_handoff_drop:
        assert st["redispatched"] >= 1
    _assert_zero_lost(st)


def test_adopt_resumes_a_snapshot_through_the_fleet(lm):
    """``ReplicaFleet.adopt`` takes a harvested snapshot as a new request
    and finishes its stream on a decode-capable replica."""
    p, steps, t, k, sd = SAMPLED
    ref = _serial_refs(lm, [SAMPLED])[0]
    pre = GenerationServer(lm[1], V, slots=2, page_size=4, role="prefill",
                           device="cpu")
    try:
        snap = pre.submit(p, steps, temperature=t, top_k=k,
                          seed=sd).result(timeout=120)
    finally:
        pre.close()
    roles = ("prefill", "decode")
    with fleet_of(_tier_factory(lm[1], roles), 2, roles=roles) as fl:
        assert fl.adopt(snap).result(timeout=120).tolist() == ref
        st = fl.stats()
    assert st["handoff_resumes"] == 1


def test_handoff_fault_modes_equal_jax():
    """``TestChaosPinning``: the same seed gives JAX's corrupt/stall/drop/
    truncate sequence, and zero-rate knobs draw nothing."""
    def run(mod):
        sleeps = []
        ch = mod.ChaosPolicy(seed=7, snapshot_corrupt_rate=0.1,
                             handoff_stall_rate=0.1, handoff_stall_s=0.5,
                             handoff_drop_rate=0.1,
                             handoff_truncate_rate=0.1, sleep=sleeps.append)
        modes = [ch.handoff_fault_mode() for _ in range(400)]
        return modes, sleeps, (ch.injected_snapshot_corrupt,
                               ch.injected_handoff_drop,
                               ch.injected_handoff_truncate,
                               ch.injected_handoff_stall)

    from deeplearning4j_torch.parallel import resilience as tres

    got = run(tres)
    assert got == run(jres)
    assert all(n > 0 for n in got[2])


# --------------------------------------------------------------------- soak
def _soak(lm, n, kill_at):
    specs = _mixed_specs(n, np.random.default_rng(42))
    refs = _serial_refs(lm, specs)
    factory = _gen_factory(lm[1], transient_rate=0.04, kill_rate=0.015,
                           stall_rate=0.02, stall_s=0.005,
                           slow_rate=0.025, slow_factor=2.0)
    with fleet_of(factory, max_pending=256, restart_backoff_s=0.02) as fl:
        futs = []
        for i, sp in enumerate(specs):
            futs.append(_submit_with_backoff(fl, sp))
            if i == kill_at:
                time.sleep(0.05)
                fl.kill_replica(0)
        _assert_streams(futs, refs, timeout=600)
        st = fl.stats()
    assert st["completed"] == n
    _assert_zero_lost(st)
    assert st["failed"] == 0 and st["expired"] == 0
    assert st["deaths"] >= 1
    per = st["replicas"]
    assert sum(r["restarts"] for r in per) == st["restarts"]
    assert sum(r["completed"] for r in per) >= st["completed"]
    for r in per:
        assert r["state"] in (READY, "dead", "spawning", "warming")


def test_chaos_soak_200_mixed_requests_zero_lost(lm):
    """``test_fleet.py``'s headline soak: 200 mixed greedy+sampled requests
    at ~10% injected replica faults plus a mid-run kill: zero lost
    futures, every stream JAX's (about 4 s on the CPU, so in tier-1)."""
    _soak(lm, 200, kill_at=60)
