"""Port parity: retries, the circuit breaker, chaos injection, the
supervised loop and the migrating drain (the port's
``parallel/resilience.py`` and ``parallel/runtime.py``, and the server
around them) against the JAX package's, on the CPU.

``RetryPolicy``, ``CircuitBreaker`` and ``ChaosPolicy`` draw from Python's
``random`` as the JAX package's do, so for the same seeds the backoffs, the
breaker's state walk and every chaos mode's fault sequence must be equal.
The server must then hold its streams under faults: transient faults are
retried to the same tokens (and, served one request at a time, the same
retry count as the JAX server under the same policy), a kill fails the
in-flight futures typed and the rebuilt server serves the same tokens
again, a tripped breaker refuses work with ``CircuitOpen``, and a migrating
drain's snapshots finish, adopted elsewhere, equal to the uninterrupted
streams. The lifecycle cases are ``tests/test_lifecycle.py``'s that need no
fleet.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.parallel import resilience as jres  # noqa: E402
from deeplearning4j_tpu.parallel import runtime as jrt  # noqa: E402
from deeplearning4j_torch.parallel import resilience as tres  # noqa: E402
from deeplearning4j_torch.parallel import runtime as trt  # noqa: E402
from deeplearning4j_torch.parallel.handoff import (  # noqa: E402
    KVSnapshot, RequestMigrated)
from tests.test_torch_speculative import V, jax_pair, make_server  # noqa

pytestmark = pytest.mark.torch_port

SERVER = dict(slots=3, page_size=8, steps_per_dispatch=2)
FAST_RETRY = dict(max_attempts=8, base_s=1e-4, cap_s=1e-3, seed=0)


@pytest.fixture(scope="module")
def lm():
    return jax_pair(3, 16)


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(6)
    return [rs.randint(0, V, n) for n in (3, 9, 5, 12)]


def _serve(srv, prompts, n, *, sequential=False, **kw):
    try:
        if sequential:
            return [srv.submit(p, n, **kw).result(timeout=120).tolist()
                    for p in prompts]
        futs = [srv.submit(p, n, **kw) for p in prompts]
        return [f.result(timeout=120).tolist() for f in futs]
    finally:
        srv.close()


def _wait_until(pred, timeout=30.0):
    t_end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < t_end, "condition never held"
        time.sleep(0.001)


def _hold_after(srv, name, n):
    """Hold the loop thread after its ``n``-th call of ``srv.<name>`` until
    the test sets the returned ``release`` event, so the test acts at a
    known point of the schedule whatever the machine's load. Returns
    (held, release) events."""
    held, release, calls = threading.Event(), threading.Event(), [0]
    real = getattr(srv, name)

    def hook(*args, **kwargs):
        out = real(*args, **kwargs)
        calls[0] += 1
        if calls[0] == n:
            held.set()
            release.wait(60)
        return out

    setattr(srv, name, hook)
    return held, release


def _drain_migrating(srv, migrate, release):
    """``srv.drain(migrate=...)`` from a helper thread while the loop is
    held: the loop is released once the drain has asked for the sweep."""
    out = []
    drainer = threading.Thread(
        target=lambda: out.append(srv.drain(timeout=30, migrate=migrate)))
    drainer.start()
    _wait_until(lambda: srv._migrating)
    release.set()
    drainer.join(60)
    assert not drainer.is_alive() and out == [True]


# ---------------------------------------------------------------- policies
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_retry_backoffs_equal_jax(seed):
    """The decorrelated-jitter backoff sequence and the sleeps ``call``
    takes before giving up are JAX's for the same seed."""
    def walk(mod):
        pol = mod.RetryPolicy(max_attempts=5, base_s=0.01, cap_s=0.2,
                              seed=seed, sleep=sleeps.append)
        delays, d = [], pol.base_s
        for _ in range(12):
            d = pol.backoff_s(d)
            delays.append(d)
        calls = []

        def flaky():
            calls.append(1)
            raise mod.TransientDispatchError("flaky")

        with pytest.raises(mod.TransientDispatchError):
            pol.call(flaky, on_retry=lambda a, e: calls.append(("retry", a)))
        return delays, calls

    sleeps = []
    want = walk(jres), list(sleeps)
    sleeps.clear()
    got = walk(tres), list(sleeps)
    assert got == want
    assert len(want[0][1]) == 5 + 4 and len(want[1]) == 4   # 4 retries


def test_retry_respects_the_deadline():
    """A backoff the deadline cannot cover gives up at once."""
    for mod in (jres, tres):
        pol = mod.RetryPolicy(max_attempts=5, base_s=1.0, cap_s=2.0,
                              seed=0, sleep=lambda s: None)
        calls = []

        def flaky():
            calls.append(1)
            raise mod.TransientDispatchError("flaky")

        with pytest.raises(mod.TransientDispatchError):
            pol.call(flaky, deadline=mod.Deadline(0.5))
        assert calls == [1]


@pytest.mark.parametrize("script", [
    "ffffffff" + "t" * 6 + "a" + "s" + "a" * 3,
    "fsfsfsff" + "t" * 6 + "a" + "f" + "a" + "t" * 6 + "aas",
    "ssssfffff" + "t" * 3 + "a" + "t" * 3 + "aaa",
], ids=["trip-probe-close", "trip-probe-reopen", "probe-budget"])
def test_breaker_state_walk_equals_jax(script):
    """The breaker's closed -> open -> half-open walk under one scripted
    sequence of outcomes (``s``/``f``), admissions (``a``) and clock ticks
    (``t``, one second) is JAX's, state and ``allow()`` verdict at every
    step."""
    def walk(mod):
        now = [0.0]
        br = mod.CircuitBreaker(failure_threshold=0.5, window=8, min_calls=4,
                                reset_timeout_s=5.0, half_open_probes=1,
                                clock=lambda: now[0])
        trace = []
        for op in script:
            if op == "s":
                br.record_success()
            elif op == "f":
                br.record_failure()
            elif op == "t":
                now[0] += 1.0
            else:
                trace.append(br.allow())
            trace.append(br.state)
        return trace, br.open_count

    want = walk(jres)
    assert walk(tres) == want
    assert "open" in want[0] and "half_open" in want[0]


def _outcome(fn):
    try:
        out = fn()
        return "ok" if out is None else repr(out)
    except BaseException as e:  # noqa: BLE001 — the outcome is the datum
        return type(e).__name__


CHAOS_MODES = {
    "wrap": dict(transient_rate=0.3, hard_rate=0.1, latency_rate=0.2,
                 latency_s=0.5),
    "replica": dict(transient_rate=0.1, kill_rate=0.1, stall_rate=0.2,
                    stall_s=0.25, slow_rate=0.2, slow_factor=1.0),
    "handoff": dict(snapshot_corrupt_rate=0.1, handoff_stall_rate=0.1,
                    handoff_stall_s=0.5, handoff_drop_rate=0.1,
                    handoff_truncate_rate=0.1),
    "shutdown": dict(kill_during_drain_rate=0.3, stall_sentinel_rate=0.3,
                     stall_sentinel_s=0.75),
    "network": dict(conn_refused_rate=0.2, partition_rate=0.1,
                    partition_s=0.0, frame_corrupt_rate=0.1,
                    slow_link_factor=3.0),
    "mixed": dict(transient_rate=0.2, kill_rate=0.05,
                  snapshot_corrupt_rate=0.2, handoff_drop_rate=0.1,
                  kill_during_drain_rate=0.1, conn_refused_rate=0.1),
}


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("mode", list(CHAOS_MODES))
def test_chaos_sequences_equal_jax(mode, seed):
    """Every fault entry point, called in one interleaved order, gives
    JAX's outcome sequence, sleeps and injection counters for the same
    seed; zero rates draw nothing."""
    def run(mod):
        sleeps = []
        ch = mod.ChaosPolicy(seed=seed, sleep=sleeps.append,
                             **CHAOS_MODES[mode])
        fn = ch.wrap(lambda: None)
        seq = []
        for i in range(150):
            seq.append(_outcome(fn))
            seq.append(repr(ch.handoff_fault_mode()))
            seq.append(_outcome(ch.drain_fault))
            seq.append(_outcome(ch.sentinel_fault))
            seq.append(_outcome(ch.net_connect_fault))
            seq.append(repr(ch.net_fault_mode(nbytes=1000 * i)))
        counters = {k: v for k, v in vars(ch).items()
                    if k.startswith("injected_")}
        return seq, sleeps, counters

    want = run(jres)
    assert run(tres) == want
    assert any(v > 0 for v in want[2].values())


def test_zero_rates_keep_legacy_sequences_pinned():
    """JAX's ``test_legacy_sequences_pinned``: zero-rate knobs draw
    nothing, so interleaved handoff checks leave the transient/hard
    sequence as it was, in both packages."""
    def pattern(mod, **kw):
        ch = mod.ChaosPolicy(seed=11, transient_rate=0.3, hard_rate=0.1,
                             **kw)
        fn = ch.wrap(lambda: "ok")
        seq = []
        for _ in range(200):
            if kw:
                assert ch.handoff_fault() is False
                assert ch.handoff_fault_mode() is None
            seq.append(_outcome(fn))
        return seq

    zeros = dict(snapshot_corrupt_rate=0.0, handoff_stall_rate=0.0,
                 handoff_drop_rate=0.0, handoff_truncate_rate=0.0,
                 kill_rate=0.0, stall_rate=0.0, slow_rate=0.0)
    want = pattern(jres)
    assert pattern(tres) == want == pattern(tres, **zeros)
    assert pattern(jres, **zeros) == want


def test_loop_killed_escapes_exception_handlers():
    """``LoopKilled`` is a BaseException in both packages (so a loop body's
    ``except Exception`` cannot swallow a chaos kill) and the taxonomy has
    JAX's shape."""
    for mod, rt in ((jres, jrt), (tres, trt)):
        assert not issubclass(rt.LoopKilled, Exception)
        assert issubclass(rt.LoopCrashed, RuntimeError)
        for name in ("DeadlineExceeded", "ServerOverloaded", "CircuitOpen",
                     "TransientDispatchError", "ReplicaKilled",
                     "ReplicaUnavailable"):
            assert issubclass(getattr(mod, name), mod.ResilienceError)


# ---------------------------------------------------------------- tick loop
def _lifecycle_walk(rt):
    """The tick loop's state walk: start, a second start refused, drain
    twice, close from four threads at once, restart after a deliberate
    close refused. Returns the states and refusals seen."""
    stop, seen = threading.Event(), []
    loop = rt.ServingLoop("walk", tick=lambda: not stop.wait(0.001),
                          wake=stop.set)
    seen.append(loop.state.value)
    loop.start()
    seen.append(loop.state.value)
    with pytest.raises(rt.IllegalLoopTransition):
        loop.start()
    loop.begin_drain()
    loop.begin_drain()
    seen.append(loop.state.value)
    closers = [threading.Thread(target=loop.close, args=(10.0,))
               for _ in range(4)]
    for t in closers:
        t.start()
    for t in closers:
        t.join(15)
    assert not any(t.is_alive() for t in closers)
    seen.append(loop.state.value)
    loop.begin_drain()                 # a no-op once CLOSED
    seen.append(loop.state.value)
    with pytest.raises(rt.IllegalLoopTransition, match="deliberate"):
        loop.restart()
    assert not any(t.is_alive() for t in loop._threads)
    return seen


def test_tick_loop_lifecycle_walk():
    """The port's tick loop walks NEW → RUNNING → DRAINING → CLOSED as
    JAX's does: drain and close idempotent, close concurrent, restart
    refused after a deliberate close."""
    want = ["new", "running", "draining", "closed", "closed"]
    assert _lifecycle_walk(jrt) == _lifecycle_walk(trt) == want


def _crash_walk(rt, res, *, restart):
    """A tick loop killed by seeded drain chaos under a private supervisor:
    returns what ``on_death`` saw and the loop's state and restart count
    once recovery settled."""
    deaths, stop = [], threading.Event()
    chaos = res.ChaosPolicy(seed=3, kill_during_drain_rate=1.0)
    loop = rt.ServingLoop("crash", tick=lambda: not stop.wait(0.001),
                          wake=lambda: None, chaos=chaos)
    sup = rt.LoopSupervisor(poll_s=0.01)
    sup.watch(loop, on_death=lambda lp, exc: deaths.append(
        type(exc).__name__) or restart, restart=True, backoff_s=0.001)
    try:
        loop.start()
        loop.begin_drain()             # the first draining tick is killed
        _wait_until(lambda: deaths)
        if restart:
            _wait_until(lambda: loop.state is rt.RUNNING)
        else:
            time.sleep(0.05)           # a vetoed restart stays CLOSED
        out = (deaths[:], loop.state.value, loop.restarts, loop.generation,
               chaos.injected_drain_kill, sup.recoveries)
    finally:
        stop.set()
        loop.close(10.0)
        sup.shutdown()
    assert not any(t.is_alive() for t in loop._threads)
    return out


@pytest.mark.parametrize("restart", [True, False],
                         ids=["restarted", "vetoed"])
def test_supervisor_recovers_a_killed_tick_loop(restart):
    """A ``LoopKilled`` drawn by drain chaos takes the tick thread down; the
    supervisor reports it to ``on_death`` once and restarts the loop unless
    ``on_death`` vetoes, in both packages alike."""
    want = (["LoopKilled"], "running" if restart else "closed",
            int(restart), int(restart), 1, 1)
    assert _crash_walk(jrt, jres, restart=restart) == want
    assert _crash_walk(trt, tres, restart=restart) == want


# ------------------------------------------------------------------ server
def test_transient_faults_retried_to_the_same_tokens(lm, prompts):
    """Transient faults on every dispatch kind are retried: the streams
    equal the fault-free server's, and served one at a time the retry and
    injection counts equal the JAX server's under the same policies."""
    ref = _serve(make_server("port", lm, **SERVER), prompts, 10,
                 sequential=True)
    counts = {}
    for which, mod in (("jax", jres), ("port", tres)):
        chaos = mod.ChaosPolicy(seed=1, transient_rate=0.3)
        srv = make_server(which, lm, chaos=chaos,
                          retry=mod.RetryPolicy(**FAST_RETRY), **SERVER)
        try:
            out = [srv.submit(p, 10).result(timeout=120).tolist()
                   for p in prompts]
        finally:
            srv.close()
        st = srv.stats()
        assert out == ref, which
        counts[which] = (st["retried"], chaos.injected_transient,
                         st["completed"], st["failed"])
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] > 0 and counts["port"][3] == 0


def test_speculative_rounds_retried_to_the_same_tokens(lm, prompts):
    """The draft prefill and the speculative round run under the same
    guard: transient faults are retried to the fault-free stream."""
    ref = _serve(make_server("port", lm, draft_net=lm, spec_k=4, **SERVER),
                 prompts, 10)
    chaos = tres.ChaosPolicy(seed=2, transient_rate=0.3)
    srv = make_server("port", lm, draft_net=lm, spec_k=4, chaos=chaos,
                      retry=tres.RetryPolicy(**FAST_RETRY), **SERVER)
    try:
        assert _serve(srv, prompts, 10) == ref
    finally:
        srv.close()
    st = srv.stats()
    assert st["retried"] > 0 and st["failed"] == 0
    assert st["pages"]["spec_rounds"] > 0


def test_kill_fails_in_flight_typed_and_serves_again(lm, prompts):
    """A ``ReplicaKilled`` mid-decode fails every in-flight and queued
    future typed, rebuilds the device state once, and the same server then
    serves the same tokens as before."""
    ref = _serve(make_server("port", lm, **SERVER), prompts, 30)
    chaos = tres.ChaosPolicy(seed=3)
    srv = make_server("port", lm, chaos=chaos,
                      **dict(SERVER, steps_per_dispatch=1))
    try:
        held, release = _hold_after(srv, "_decode_once", 1)
        futs = [srv.submit(p, 30) for p in prompts]
        assert held.wait(60)
        chaos.kill_rate = 1.0          # the next dispatch is killed
        release.set()
        for f in futs:
            with pytest.raises(tres.ReplicaKilled):
                f.result(timeout=60)
        chaos.kill_rate = 0.0
        st = srv.stats()
        assert st["pool_rebuilds"] == 1 and st["failed"] == len(prompts)
        assert st["active_slots"] == 0 and st["queued"] == 0
        assert st["pages"]["pages_refcounted"] == 0
        again = [srv.submit(p, 30) for p in prompts]
        assert [f.result(timeout=120).tolist() for f in again] == ref
    finally:
        srv.close()


def test_loop_death_mid_migration_restarts_the_loop(lm, prompts):
    """A chaos kill of the loop thread during a migrating drain fails the
    in-flight futures ``LoopCrashed``; the supervisor rebuilds the device
    state and restarts the loop, which serves the same tokens again."""
    ref = _serve(make_server("port", lm, **SERVER), prompts[:2], 6)
    chaos = tres.ChaosPolicy(seed=13, kill_during_drain_rate=1.0)
    srv = make_server("port", lm, chaos=chaos, **SERVER)
    try:
        futs = [srv.submit(p, 40) for p in prompts]
        assert srv.drain(timeout=30, migrate=True) is True
        assert chaos.injected_drain_kill >= 1
        for f in futs:
            with pytest.raises(trt.LoopCrashed):
                f.result(timeout=30)
        _wait_until(lambda: srv._runtime.state is trt.RUNNING)
        assert srv._runtime.restarts >= 1
        chaos.kill_during_drain_rate = 0.0
        again = [srv.submit(p, 6) for p in prompts[:2]]
        assert [f.result(timeout=60).tolist() for f in again] == ref
        assert srv.stats()["pool_rebuilds"] >= 1
    finally:
        srv.close(timeout=10)


def test_tripped_breaker_refuses_work(lm):
    """Hard dispatch faults trip the breaker; ``submit`` and
    ``adopt_request`` then fail fast with ``CircuitOpen``."""
    chaos = tres.ChaosPolicy(seed=0, hard_rate=1.0)
    breaker = tres.CircuitBreaker(failure_threshold=0.5, window=4,
                                  min_calls=2, reset_timeout_s=60.0)
    srv = make_server("port", lm, chaos=chaos, breaker=breaker, **SERVER)
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="hard fault"):
                srv.submit(np.arange(3), 4).result(timeout=60)
        assert srv.stats()["breaker_state"] == "open"
        with pytest.raises(tres.CircuitOpen):
            srv.submit(np.arange(3), 4)
        snap_src = make_server("port", lm, role="prefill", **SERVER)
        try:
            snap = snap_src.submit(np.arange(3), 4).result(timeout=60)
        finally:
            snap_src.close()
        with pytest.raises(tres.CircuitOpen):
            srv.adopt_request(snap)
        assert srv.metrics.snapshot()["generation_breaker_open"] == 1.0
    finally:
        srv.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("sink", [False, True], ids=["flag", "callable"])
def test_migrating_drain_snapshots_finish_elsewhere(lm, prompts, kv_dtype,
                                                    sink):
    """``drain(migrate=True | callable)`` fails every request
    ``RequestMigrated``: each live one with a snapshot at its stream
    position (handed to the callable too), the queued one without. A second
    server adopts the snapshots (and serves the queued request afresh), and
    every completion equals the JAX server's uninterrupted stream, greedy
    and sampled."""
    kw = [dict(temperature=0.8, top_k=6, seed=40 + i) if i % 2 else {}
          for i in range(len(prompts))]
    src_kw = dict(SERVER, kv_dtype=kv_dtype)
    srv = make_server("jax", lm, **src_kw)
    try:
        ref = [srv.submit(p, 24, **k).result(timeout=120).tolist()
               for p, k in zip(prompts, kw)]
    finally:
        srv.close()
    srv = make_server("port", lm, **src_kw)
    got = []
    try:
        held, release = _hold_after(srv, "_decode_once", 3)
        futs = [srv.submit(p, 24, **k) for p, k in zip(prompts, kw)]
        assert held.wait(60)
        _drain_migrating(srv, got.append if sink else True, release)
        for f in futs:
            assert isinstance(f.exception(timeout=30), RequestMigrated)
        snaps = [getattr(f, "_kv_snapshot", None) for f in futs]
        st = srv.stats()
    finally:
        srv.close()
    live = [s for s in snaps if s is not None]
    # three slots: the fourth request was still queued and leaves bare
    assert len(live) == SERVER["slots"] and snaps[-1] is None
    assert st["handoff"]["migrated"] == len(prompts)
    assert st["pages"]["pages_refcounted"] == 0
    if sink:
        assert [s.to_bytes() for s in got] == [s.to_bytes() for s in live]
    dst = make_server("port", lm, **src_kw)
    try:
        futs = [dst.submit(p, 24, **k) if s is None else
                dst.adopt_request(KVSnapshot.from_bytes(s.to_bytes()))
                for p, k, s in zip(prompts, kw, snaps)]
        assert [f.result(timeout=120).tolist() for f in futs] == ref
        assert dst.stats()["handoff"]["resumes"] == len(live)
    finally:
        dst.close()


def test_speculative_drain_migrates_without_snapshots(lm, prompts):
    """A speculative server migrates snapshot-free: every live future
    still fails ``RequestMigrated``, none is lost."""
    srv = make_server("port", lm, draft_net=lm, spec_k=4, **SERVER)
    try:
        held, release = _hold_after(srv, "_spec_decode_once", 1)
        futs = [srv.submit(p, 40) for p in prompts]
        assert held.wait(60)
        _drain_migrating(srv, True, release)
        for f in futs:
            exc = f.exception(timeout=30)
            assert isinstance(exc, RequestMigrated)
            assert getattr(f, "_kv_snapshot", None) is None
        assert srv.stats()["handoff"]["migrated"] == len(prompts)
    finally:
        srv.close()


# --------------------------------------------------------------- lifecycle
def test_drain_twice_then_close_twice(lm):
    srv = make_server("port", lm, **SERVER)
    f = srv.submit(np.array([3, 1, 4]), 3)
    assert srv.drain(5.0) is True and srv.drain(5.0) is True
    assert f.result(timeout=5).size == 3
    srv.close(10.0)
    srv.close(10.0)


def test_concurrent_close_from_four_threads(lm):
    srv = make_server("port", lm, **SERVER)
    f = srv.submit(np.array([3, 1, 4]), 3)
    errs = []

    def closer():
        try:
            srv.close(10.0)
        except Exception as e:  # noqa: BLE001 — the assertion target
            errs.append(e)

    ts = [threading.Thread(target=closer) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts) and errs == []
    assert f.done()


def test_drain_after_close_and_submit_after_close(lm):
    srv = make_server("port", lm, **SERVER)
    srv.close(10.0)
    assert srv.drain(timeout=1.0) is True
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.array([3, 1, 4]), 3)
    srv.close(10.0)
    assert srv._runtime.state is trt.CLOSED


@pytest.mark.parametrize("spec_k", [0, 4, 5], ids=["plain", "spec4", "spec5"])
def test_fault_after_pool_writes_retried_to_same_tokens(lm, spec_k):
    """A transient fault that strikes after a forward has written the pool
    in place (every third target forward raises once it has run) is
    retried from the same host state: the retry rewrites the same values
    at the same slots, positions, counts, the block table and the
    copy-on-write pages advance only after the dispatch returns, and the
    streams (shared-prefix prompts, greedy and sampled) equal the
    fault-free server's."""
    rs = np.random.RandomState(8)
    system = rs.randint(0, V, 16)
    prompts = [np.concatenate([system, rs.randint(0, V, n)])
               for n in (2, 7, 4)]
    kw = dict(SERVER, draft_net=lm, spec_k=spec_k) if spec_k else SERVER

    def serve(srv):
        try:
            out = [srv.submit(prompts[0], 12).result(timeout=120).tolist()]
            futs = [srv.submit(p, 12, temperature=0.8, top_k=5, seed=i)
                    for i, p in enumerate(prompts[1:])]
            return out + [f.result(timeout=120).tolist() for f in futs]
        finally:
            srv.close()

    ref = serve(make_server("port", lm, **kw))
    # a breaker that trips only when every attempt fails: this is about
    # the retries, at a fault rate the default breaker would shed
    srv = make_server("port", lm, retry=tres.RetryPolicy(**FAST_RETRY),
                      breaker=tres.CircuitBreaker(failure_threshold=1.0),
                      **kw)
    real, calls = srv._fwd, [0]

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        calls[0] += 1
        if calls[0] % 3 == 0:
            raise tres.TransientDispatchError("fault after the pool write")
        return out

    srv._fwd = faulty
    assert serve(srv) == ref
    st = srv.stats()
    assert st["retried"] >= 2 and st["failed"] == 0
    assert st["pages"]["cow_copies"] >= 1
