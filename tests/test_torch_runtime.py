"""Port parity: the inbox mode of the serving runtime (the port's
``parallel/runtime.py``: ``handler=``, the worker pool, ``put``/``get``/
``set_workers``/``fail_leftovers``, the one-sentinel walk) against the JAX
package's ``ServingLoop``, on the CPU.

Each scenario is the scripted handler of ``tests/test_runtime.py``
(``TestStateMachine``, ``TestWorkerPool``, ``TestSupervisor``) run on both
packages' loops: the state walks, worker counts, handled and leftover items
and the supervisor's verdicts must be equal. The shutdown-chaos cases
(``TestShutdownChaos``) run the port's ``ParallelInference`` and
``ReplicaFleet`` beside the JAX ones under the same seeded ``ChaosPolicy``:
every future resolves (no hang), the admission ledgers balance in both, and
the failures are of the same types. Every wait carries its own timeout.
"""

import queue
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.parallel import resilience as jres  # noqa: E402
from deeplearning4j_tpu.parallel import runtime as jrt  # noqa: E402
from deeplearning4j_tpu.parallel.fleet import (  # noqa: E402
    ReplicaFleet as JaxFleet)
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_tpu.parallel.inference import (  # noqa: E402
    ParallelInference as JaxParallelInference)
from deeplearning4j_torch.parallel import resilience as tres  # noqa: E402
from deeplearning4j_torch.parallel import runtime as trt  # noqa: E402
from deeplearning4j_torch.parallel.fleet import ReplicaFleet  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.parallel.inference import (  # noqa: E402
    ParallelInference)
from tests.test_torch_inference import features, mln_pair  # noqa: E402
from tests.test_torch_speculative import V, jax_pair  # noqa: E402

pytestmark = pytest.mark.torch_port


def _wait_until(pred, timeout=10.0, step=0.005):
    limit = time.monotonic() + timeout
    while time.monotonic() < limit:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _resolve_all(futs, timeout=30.0):
    """Each future's outcome: ``("ok", None)`` or ``("err", type name)``. A
    future still unresolved past ``timeout`` fails the test."""
    out = []
    for f in futs:
        try:
            f.result(timeout=timeout)
            out.append(("ok", None))
        except FuturesTimeout:
            pytest.fail("future left unresolved past the deadline")
        except Exception as e:  # noqa: BLE001 - typed failure is the point
            out.append(("err", type(e).__name__))
    return out


# ----------------------------------------------------------- state machine
def _state_walk(rt):
    """NEW → RUNNING → DRAINING (twice) → CLOSED (twice), then a put."""
    done = []
    loop = rt.ServingLoop("sm", handler=done.append)
    seen = [loop.state.value]
    loop.start()
    seen.append(loop.state.value)
    for _ in range(2):
        loop.begin_drain()
        seen.append(loop.state.value)
    for _ in range(2):
        loop.close(timeout=5)
        seen.append(loop.state.value)
    try:
        loop.put("late")
    except rt.LoopError as e:
        seen.append(type(e).__name__)
    return seen


def _refusals(rt):
    """The transitions the state machine refuses, by type and message."""
    out = []
    loop = rt.ServingLoop("sm2", handler=lambda i: None).start()
    for call in (loop.start, loop.restart):
        try:
            call()
        except rt.IllegalLoopTransition as e:
            out.append(str(e))
    loop.close(timeout=5)
    try:
        loop.restart()
    except rt.IllegalLoopTransition as e:
        out.append(str(e))
    try:
        rt.ServingLoop("neither")
    except ValueError as e:
        out.append(str(e))
    tick = rt.ServingLoop("ticker", tick=lambda: False)
    for call in (lambda: tick.put(1), lambda: tick.get(timeout=0.01),
                 lambda: tick.set_workers(2)):
        try:
            call()
        except rt.LoopError as e:
            out.append(str(e))
    assert tick.fail_leftovers() == 0
    return out


def test_state_walk_and_refusals_equal_jax():
    want = ["new", "running", "draining", "draining", "closed", "closed",
            "LoopClosed"]
    assert _state_walk(jrt) == _state_walk(trt) == want
    got = _refusals(trt)
    assert got == _refusals(jrt)
    assert got[0] == "sm2: start() from running"
    assert "deliberate" in got[2]


# ------------------------------------------------------------- worker pool
def _sentinel_walk(rt):
    seen, lock = [], threading.Lock()

    def handle(item):
        with lock:
            seen.append(item)

    loop = rt.ServingLoop("pool", handler=handle, workers=3,
                          max_workers=3).start()
    alive = loop.alive_workers
    names = sorted(t.name for t in loop.threads)
    for i in range(9):
        loop.put(i)
    loop.close(timeout=10)
    assert not any(t.is_alive() for t in loop.threads)
    return sorted(seen), alive, loop.alive_workers, names, loop.stats()


def _exit_token(rt):
    loop = rt.ServingLoop(
        "exiter", workers=2, max_workers=2,
        handler=lambda item: rt.EXIT if item == "quit" else None).start()
    counts = [loop.alive_workers]
    for want in (1, 0):
        loop.put("quit")
        assert _wait_until(lambda: loop.alive_workers == want)
        counts.append(loop.alive_workers)
    loop.close(timeout=5)
    return counts, loop.crashed is None


def _carry(rt):
    seen = []

    def handle(item):
        seen.append(item)
        return item[1] if isinstance(item, tuple) else None

    loop = rt.ServingLoop("carry", handler=handle).start()
    loop.put(("carry", "head"))
    assert _wait_until(lambda: "head" in seen)
    loop.close(timeout=5)
    return seen


def _scaling(rt):
    loop = rt.ServingLoop("scale", handler=lambda i: None, workers=1,
                          max_workers=4).start()
    out = []
    for n in (3, 1, 9, 0):
        got = loop.set_workers(n)
        want = max(1, min(n, 4))
        assert _wait_until(lambda: loop.alive_workers == want)
        out.append((got, loop.alive_workers))
    loop.begin_drain()
    out.append(loop.set_workers(3))      # refused once the loop drains
    loop.close(timeout=5)
    out.append(loop.alive_workers)
    return out


def _leftovers(rt):
    failed = []
    loop = rt.ServingLoop("leftover", handler=lambda i: None,
                          on_leftover=failed.append).start()
    loop.put(rt._RESIGN)          # retire the sole worker: queue unserved
    assert _wait_until(lambda: loop.alive_workers == 0)
    for i in range(3):
        loop.put(i)
    loop.put(rt._SENTINEL)        # control tokens are never leftovers
    loop.close(timeout=5)
    again = loop.fail_leftovers()
    return sorted(failed), again, loop.state.value


def _get_skips_tokens(rt):
    """A batching handler's ``get`` never hands out a control token: the
    token is re-queued and the call raises ``Empty``."""
    loop = rt.ServingLoop("getter", handler=lambda i: None)
    loop._inbox.put(rt._SENTINEL)
    loop._inbox.put("x")
    out = []
    try:
        loop.get(timeout=0.01)
    except queue.Empty:
        out.append("empty")
    out.append(loop.get(timeout=0.01))
    out.append(loop._inbox.get_nowait() is rt._SENTINEL)
    return out


@pytest.mark.parametrize("scenario", [_sentinel_walk, _exit_token, _carry,
                                      _scaling, _leftovers,
                                      _get_skips_tokens],
                         ids=lambda f: f.__name__.strip("_"))
def test_worker_pool_equals_jax(scenario):
    """``TestWorkerPool``'s scripted handlers on both loops: one sentinel
    walks the whole pool down, ``EXIT`` retires one worker, a carried item
    is the next head, ``set_workers`` clamps and scales both ways (and does
    nothing once draining), leftovers are failed once and never stranded,
    ``get`` skips control tokens."""
    assert scenario(trt) == scenario(jrt)


def test_worker_pool_expected_values():
    """The shared observations are the right ones, not only equal."""
    items, alive, after, names, stats = _sentinel_walk(trt)
    assert items == list(range(9)) and alive == 3 and after == 0
    assert names == ["pool-1", "pool-2", "pool-3"]
    assert stats == {"name": "pool", "state": "closed", "workers": 0,
                     "generation": 0, "restarts": 0, "crashed": False}
    assert _exit_token(trt) == ([2, 1, 0], True)
    assert _carry(trt) == [("carry", "head"), "head"]
    assert _scaling(trt) == [(3, 3), (1, 1), (4, 4), (1, 1), 1, 0]
    assert _leftovers(trt) == ([0, 1, 2], 0, "closed")
    assert _get_skips_tokens(trt) == ["empty", "x", True]


def test_worker_exit_hook_sees_every_exit():
    """``on_worker_exit`` fires once per retired worker, with the crash
    exception or None, in both packages."""
    def run(rt):
        exits, lock = [], threading.Lock()

        def hook(loop, exc):
            with lock:
                exits.append(None if exc is None else type(exc).__name__)

        def handle(item):
            if item == "boom":
                raise KeyError(item)

        loop = rt.ServingLoop("hooked", handler=handle, workers=2,
                              max_workers=2, on_worker_exit=hook).start()
        loop.put("boom")
        assert _wait_until(lambda: loop.alive_workers == 1)
        loop.close(timeout=5)
        return sorted(exits, key=str), type(loop.crashed).__name__

    assert run(trt) == run(jrt) == (["KeyError", None], "KeyError")


# -------------------------------------------------------------- supervisor
def _crash_restart(rt):
    seen, deaths = [], []
    sup = rt.LoopSupervisor(poll_s=0.005)

    def handle(item):
        if item == "poison":
            raise ValueError("boom")
        seen.append(item)

    loop = rt.ServingLoop("crashy", handler=handle).start()
    sup.watch(loop, on_death=lambda lp, e: deaths.append(
        type(e).__name__) or True, restart=True, backoff_s=0.001)
    try:
        loop.put("a")
        assert _wait_until(lambda: "a" in seen)
        loop.put("poison")
        assert _wait_until(lambda: loop.restarts >= 1)
        assert _wait_until(lambda: loop.state is rt.RUNNING)
        loop.put("b")             # the restarted loop serves
        assert _wait_until(lambda: "b" in seen)
        return (seen[:], deaths[:], loop.restarts, loop.generation,
                sup.recoveries)
    finally:
        loop.close(timeout=5)
        sup.shutdown()


def _veto(rt):
    sup = rt.LoopSupervisor(poll_s=0.005)
    failed = []
    loop = rt.ServingLoop(
        "vetoed", handler=lambda i: (_ for _ in ()).throw(ValueError(i)),
        on_leftover=failed.append).start()
    sup.watch(loop, on_death=lambda lp, e: False, restart=True)
    try:
        loop.put("x")
        assert _wait_until(lambda: loop.state is rt.CLOSED)
        time.sleep(0.05)          # a few scan periods: no resurrection
        return loop.restarts, loop.state.value, sup.recoveries
    finally:
        loop.close(timeout=5)
        sup.shutdown()


def _calm_close(rt):
    sup = rt.LoopSupervisor(poll_s=0.005)
    loop = rt.ServingLoop("calm", handler=lambda i: None).start()
    sup.watch(loop, restart=True)
    try:
        loop.close(timeout=5)
        time.sleep(0.05)
        return loop.restarts, sup.recoveries
    finally:
        sup.shutdown()


def test_supervisor_verdicts_equal_jax():
    """A crashed inbox loop is detected, reported once and restarted (and
    serves again); ``on_death`` returning False vetoes the restart; a
    deliberate close is never a crash."""
    want = (["a", "b"], ["ValueError"], 1, 1, 1)
    assert _crash_restart(trt) == _crash_restart(jrt) == want
    assert _veto(trt) == _veto(jrt) == (0, "closed", 1)
    assert _calm_close(trt) == _calm_close(jrt) == (0, 0)


# ------------------------------------------ shutdown chaos, zero lost futures
@pytest.fixture(scope="module")
def mlns():
    return mln_pair()


@pytest.fixture(scope="module")
def lm():
    return jax_pair(3, 16)


def _pi_ledger(st):
    return st["pending"] == 0 and \
        st["accepted"] == st["completed"] + st["failed"]


def _pi_chaos(which, mlns, chaos_kw, n, close_timeout):
    """Submit ``n`` rows to a ParallelInference under ``chaos_kw`` and close
    it: returns the outcomes, whether the ledger balanced, the injection
    counters and the close time."""
    jnet, tnet = mlns
    res = jres if which == "jax" else tres
    chaos = res.ChaosPolicy(**chaos_kw)
    x = features(n)
    if which == "jax":
        inf = JaxParallelInference(jnet, workers=1, max_wait_ms=5,
                                   chaos=chaos)
    else:
        inf = ParallelInference(tnet, max_wait_ms=5, chaos=chaos,
                                device="cpu")
    futs = [inf.submit(x[i:i + 1]) for i in range(n)]
    t0 = time.monotonic()
    inf.close(timeout=close_timeout)
    took = time.monotonic() - t0
    outcomes = _resolve_all(futs, timeout=10)
    return (outcomes, _pi_ledger(inf.stats()), chaos.injected_drain_kill,
            chaos.injected_sentinel_stall, took)


@pytest.mark.parametrize("case", ["kill_during_drain", "sentinel_stall"])
def test_pi_shutdown_chaos_loses_nothing(mlns, case):
    """A coalescer or completer killed mid-drain, or a stalled sentinel
    retire, loses no future in either package: every one resolves (rows or
    a typed failure of the same types), the admission ledger balances, the
    fault landed, and close stays bounded."""
    if case == "kill_during_drain":
        kw, n, timeout = dict(seed=7, kill_during_drain_rate=1.0), 8, 3
    else:
        kw, n, timeout = dict(seed=3, stall_sentinel_rate=1.0,
                              stall_sentinel_s=0.4), 4, 2
    runs = {w: _pi_chaos(w, mlns, kw, n, timeout) for w in ("jax", "port")}
    for which, (outcomes, balanced, kills, stalls, took) in runs.items():
        assert balanced, which
        assert took < 15, which
        if case == "kill_during_drain":
            assert kills >= 1, which
        else:
            assert stalls >= 1, which
    kinds = {w: {k for o in r[0] for k in o if isinstance(k, str)}
             for w, r in runs.items()}
    assert kinds["port"] <= kinds["jax"] | {"ok"}, kinds


def test_fleet_kill_mid_close_loses_nothing(lm):
    """Drain chaos kills the fleet monitor mid-close: every request still
    resolves in both packages, with outcomes of the same kinds."""
    jnet, tnet = lm
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, V, 3) for _ in range(3)]
    kinds = {}
    for which in ("jax", "port"):
        res = jres if which == "jax" else tres
        chaos = res.ChaosPolicy(seed=17, kill_during_drain_rate=1.0)
        if which == "jax":
            fl = JaxFleet(lambda rid: JaxGenerationServer(
                jnet, V, slots=2, paged_attention="xla"), replicas=1,
                chaos=chaos)
        else:
            fl = ReplicaFleet(lambda rid: GenerationServer(
                tnet, V, slots=2, device="cpu"), replicas=1, chaos=chaos)
        try:
            futs = [fl.submit(p, 3) for p in prompts]
        finally:
            fl.close(timeout=10)
        assert chaos.injected_drain_kill >= 1, which
        kinds[which] = {o[0] for o in _resolve_all(futs, timeout=10)}
    assert kinds["port"] <= kinds["jax"] | {"ok"}, kinds


N_THREADS = 4
PER_THREAD = 6


@pytest.mark.parametrize("kind", ["inference", "generation", "fleet"])
def test_submit_vs_close_stress(kind, mlns, lm):
    """``test_runtime.py``'s seeded stress on the port: N threads hammer
    submit() while close() lands mid-burst; every accepted future resolves
    within the deadline, every rejected submit raises typed, no caller
    hangs, and close stays idempotent after the storm."""
    if kind == "inference":
        srv = ParallelInference(mlns[1], max_wait_ms=5, device="cpu")
        x = features(1)
        do_submit = lambda: srv.submit(x)  # noqa: E731
    elif kind == "generation":
        srv = GenerationServer(lm[1], V, slots=2, device="cpu")
        do_submit = lambda: srv.submit(np.array([3, 1, 4]), 2)  # noqa: E731
    else:
        srv = ReplicaFleet(lambda rid: GenerationServer(
            lm[1], V, slots=2, device="cpu"), replicas=1)
        do_submit = lambda: srv.submit(np.array([3, 1, 4]), 2)  # noqa: E731

    futs, bad = [], []
    flock = threading.Lock()
    start_evt = threading.Event()

    def hammer(tid):
        jitter = np.random.RandomState(100 + tid)
        start_evt.wait(5)
        for _ in range(PER_THREAD):
            try:
                f = do_submit()
                with flock:
                    futs.append(f)
            except Exception as e:  # noqa: BLE001 - typed check below
                with flock:
                    bad.append(e)
            time.sleep(float(jitter.uniform(0.0, 0.004)))

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(N_THREADS)]
    try:
        for t in threads:
            t.start()
        start_evt.set()
        time.sleep(0.01)
        srv.close(timeout=15)
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        _resolve_all(futs, timeout=30)
        for e in bad:
            assert isinstance(e, Exception) and e.args, repr(e)
    finally:
        srv.close(timeout=5)
