"""Port parity: the coalescing ``ParallelInference`` (the port's
``parallel/inference.py`` and ``optimize/bucketing.py::BoundedCache``)
against the JAX package's, on the CPU: the cases of
``tests/test_inference_server.py`` and the ParallelInference classes of
``tests/test_resilience.py``.

Both packages' nets hold the same weights (``params_from_jax``; the MLN and
the graph of ``tests/test_fused_fit.py``). The JAX server runs with
``workers=1``, so both pad to the same buckets. Checked:

- rows within ``ATOL`` (1e-5) of the JAX server's, for a MultiLayerNetwork,
  a ComputationGraph and the int8-weight case (``quantize="int8"``), and
  bit for bit the port net's own ``output()`` at the same bucket size;
- JAX's dispatch counts where coalescing is deterministic (a full
  ``max_batch`` under a long window is one dispatch), the same bucket
  keys, ``stats()`` with JAX's keys in its order and equal counts;
- the same typed errors (``ServerOverloaded``, ``CircuitOpen``,
  ``DeadlineExceeded``, closed and draining servers, a request staged
  behind the shutdown sentinel, a submit racing close);
- retries, the breaker's recovery, and the 200-submit chaos ledger.

Every ``result()`` and ``join()`` carries its own timeout, and every server
is closed in a ``finally`` or a ``with``.
"""

import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.optimize import bucketing as jbucketing  # noqa: E402
from deeplearning4j_tpu.parallel import resilience as jres  # noqa: E402
from deeplearning4j_tpu.parallel.inference import (  # noqa: E402
    ParallelInference as JaxParallelInference)
from deeplearning4j_torch.nn.conf.builders import (  # noqa: E402
    NeuralNetConfiguration)
from deeplearning4j_torch.nn.conf.inputs import InputType  # noqa: E402
from deeplearning4j_torch.nn.conf.layers.core import (  # noqa: E402
    DenseLayer, OutputLayer)
from deeplearning4j_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_torch.nn.updater import Adam  # noqa: E402
from deeplearning4j_torch.optimize import bucketing as tbucketing  # noqa
from deeplearning4j_torch.parallel import resilience as tres  # noqa: E402
from deeplearning4j_torch.parallel.inference import (  # noqa: E402
    ParallelInference)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

ATOL = 1e-5


def features(n, seed=0):
    """``tests/test_fused_fit.py::_iris_like`` features."""
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


def _builder():
    return (NeuralNetConfiguration.builder().seed(12345).updater(Adam(0.02))
            .weight_init("xavier").activation("relu"))


def mln_pair():
    """JAX's ``_mln()`` and the port's MultiLayerNetwork on its weights."""
    from tests.test_fused_fit import _mln

    jnet = _mln()
    conf = (_builder()
            .list(DenseLayer(n_out=16), DenseLayer(n_out=16),
                  OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    tnet = MultiLayerNetwork(conf).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def graph_pair():
    """JAX's ``_graph()`` and the port's ComputationGraph on its weights."""
    from tests.test_fused_fit import _graph

    jnet = _graph()
    conf = (_builder().graph_builder().add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=16), "in")
            .add_layer("out", OutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"), "d1")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    tnet = ComputationGraph(conf).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


@pytest.fixture(scope="module")
def mlns():
    return mln_pair()


@pytest.fixture(scope="module")
def graphs():
    return graph_pair()


def _servers(pair, **kw):
    """The JAX and the port server over one net pair, same knobs."""
    jkw, tkw = dict(kw), dict(kw)
    if "chaos" in kw:
        jkw["chaos"] = jres.ChaosPolicy(**kw["chaos"])
        tkw["chaos"] = tres.ChaosPolicy(**kw["chaos"])
    for k, cls in (("retry", "RetryPolicy"), ("breaker", "CircuitBreaker")):
        if isinstance(kw.get(k), dict):
            jkw[k] = getattr(jres, cls)(**kw[k])
            tkw[k] = getattr(tres, cls)(**kw[k])
    return (JaxParallelInference(pair[0], workers=1, **jkw),
            ParallelInference(pair[1], device="cpu", **tkw))


def _submit_rows(inf, x, step=1):
    futs = [inf.submit(x[i:i + step]) for i in range(0, len(x), step)]
    return np.concatenate([np.asarray(f.result(timeout=30)) for f in futs])


# ------------------------------------------------------------------- rows
@pytest.mark.parametrize("which", ["mln", "graph", "int8"])
def test_rows_equal_jax(which, mlns, graphs):
    """Coalesced single-row submits: every row within ``ATOL`` of the JAX
    server's, and the port's ``output()`` bit for bit the port net's own
    at the same bucket size."""
    pair = graphs if which == "graph" else mlns
    kw = dict(quantize="int8") if which == "int8" else {}
    x = features(24, seed=4)
    jinf, tinf = _servers(pair, max_wait_ms=20, **kw)
    try:
        jrows = _submit_rows(jinf, x)
        trows = _submit_rows(tinf, x)
        tout = tinf.output(x)
    finally:
        jinf.close()
        tinf.close()
    assert trows.shape == jrows.shape == (24, 3)
    np.testing.assert_allclose(trows, jrows, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tout, jrows, rtol=0, atol=ATOL)
    if which != "int8":
        own = pair[1].output(x)
        own = own.numpy() if torch.is_tensor(own) else own
        np.testing.assert_array_equal(tout, own)
    else:
        # the caller's net keeps its f32 weights
        assert not any(k.endswith("_scale") for p in pair[1].params.values()
                       for k in p)


def test_order_preserved_and_single_example_promoted(mlns):
    """Each future resolves to exactly its own rows, in row order (2-row
    submits), and a 1-D feature vector is a 1-row batch."""
    x = features(16, seed=3)
    with ParallelInference(mlns[1], max_wait_ms=50, device="cpu") as inf:
        seq = inf.output(x)
        futs = [inf.submit(x[i:i + 2]) for i in range(0, 16, 2)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30),
                                          seq[2 * i:2 * i + 2])
        one = inf.submit(x[0]).result(timeout=30)
    assert one.shape == (1, 3)
    np.testing.assert_allclose(one, seq[:1], rtol=0, atol=ATOL)


# ------------------------------------------------------- dispatch counting
@pytest.mark.parametrize("n,max_batch", [(8, 8), (32, 32)])
def test_full_batch_is_one_dispatch_like_jax(mlns, n, max_batch):
    """``test_max_batch_triggers_immediate_dispatch``: ``max_batch`` rows
    under a 10 s window dispatch at once, as ONE forward in both packages,
    with equal ``stats()`` (JAX's keys in its order)."""
    x = features(n, seed=2)
    stats = {}
    for which, inf in zip(("jax", "port"),
                          _servers(mlns, max_batch=max_batch,
                                   max_wait_ms=10_000)):
        try:
            t0 = time.monotonic()
            rows = _submit_rows(inf, x)
            # a full batch dispatches at once, not when the window closes
            assert time.monotonic() - t0 < 9, which
        finally:
            inf.close()
        assert rows.shape == (n, 3)
        stats[which] = inf.stats()
    assert list(stats["port"]) == list(stats["jax"])
    assert stats["port"] == stats["jax"]
    assert stats["port"]["dispatches"] == 1
    assert stats["port"]["completed"] == n


def test_32_submits_coalesce_to_at_most_two_dispatches(mlns):
    """The acceptance criterion of ``test_32_submits_coalesce_to_two_
    dispatches``: 32 concurrent 1-row submits, at most 2 forwards, rows
    equal to ``output()``."""
    x = features(32)
    with ParallelInference(mlns[1], max_wait_ms=200, device="cpu") as inf:
        ref = inf.output(x)
        base = inf.dispatch_count
        rows = _submit_rows(inf, x)
        assert inf.dispatch_count - base <= 2
    np.testing.assert_allclose(rows, ref, rtol=0, atol=ATOL)


def test_bucket_keys_equal_jax():
    """``output()`` of sizes 1..9 and 16 pads to the same power-of-two
    buckets in both packages: the port's forward cache holds JAX's program
    keys (JAX keeps them in the net's own cache: fresh nets here), and
    each size's rows equal JAX's."""
    pair = mln_pair()
    jnet = pair[0]
    jinf, tinf = _servers(pair)
    x = features(16, seed=7)
    for n in list(range(1, 10)) + [16]:
        np.testing.assert_allclose(tinf.output(x[:n]), jinf.output(x[:n]),
                                   rtol=0, atol=ATOL)
    jkeys = {(k[1], k[2]) for k in jnet._output_cache if k[0] == "pi_fwd"}
    assert set(tinf._fwd_cache) == jkeys
    assert {k[0][0] for k in jkeys} == {1, 2, 4, 8, 16}


def test_bounded_cache_evicts_as_jax():
    """``BoundedCache`` keeps JAX's LRU order: reads refresh, inserts past
    ``maxsize`` evict the least recently used."""
    def run(mod):
        c = mod.BoundedCache(maxsize=3)
        for k in "abc":
            c[k] = k.upper()
        _ = c["a"]
        c["d"] = "D"
        c["e"] = "E"
        try:
            mod.BoundedCache(maxsize=0)
        except ValueError as e:
            err = str(e)
        return list(c.items()), err

    assert run(tbucketing) == run(jbucketing)
    assert run(tbucketing)[0] == [("a", "A"), ("d", "D"), ("e", "E")]
    assert (tbucketing.DEFAULT_CACHE_PROGRAMS
            == jbucketing.DEFAULT_CACHE_PROGRAMS)


# -------------------------------------------------------------- typed errors
def _outcome(call):
    try:
        out = call()
        if hasattr(out, "result"):
            out = out.result(timeout=30)
        return ("ok", np.asarray(out).shape)
    except Exception as e:  # noqa: BLE001 - the type is the observation
        return (type(e).__name__, str(e))


def _typed_errors(inf, x):
    """Deadline, draining and closed refusals, in order."""
    out = [_outcome(lambda: inf.submit(x, deadline_s=0.0)),
           _outcome(lambda: inf.submit(x, deadline_s=60.0))]
    assert inf.drain(timeout=30)
    out.append(_outcome(lambda: inf.submit(x)))
    inf.close()
    out.append(_outcome(lambda: inf.submit(x)))
    out.append((inf.stats()["expired"], inf.dispatch_count))
    return out


def test_typed_errors_equal_jax(mlns):
    """A born-expired request fails ``DeadlineExceeded`` without a forward;
    a draining and a closed server refuse with the same messages."""
    x = features(1)
    got = [_typed_errors(inf, x) for inf in _servers(mlns, max_wait_ms=5)]
    assert [o[0] for o in got[1][:4]] == [o[0] for o in got[0][:4]] == [
        "DeadlineExceeded", "ok", "RuntimeError", "RuntimeError"]
    assert got[1][2:] == got[0][2:]
    assert got[1][4] == (1, 1)


def test_overload_sheds_typed_like_jax(mlns):
    """``test_burst_beyond_watermark_sheds_typed``: past ``max_pending``
    submits fail ``ServerOverloaded`` at once; every admitted request still
    resolves and the ledger balances, in both packages."""
    for inf in _servers(mlns, max_batch=4, max_wait_ms=1, inflight=1,
                        max_pending=8,
                        chaos=dict(seed=0, latency_rate=1.0,
                                   latency_s=0.05)):
        try:
            admitted, shed = [], []
            for i in range(40):
                try:
                    admitted.append(inf.submit(features(1, seed=i)))
                except Exception as e:  # noqa: BLE001 - typed check
                    shed.append(type(e).__name__)
            assert shed and set(shed) == {"ServerOverloaded"}
            for f in admitted:
                assert f.result(timeout=60).shape == (1, 3)
            st = inf.stats()
        finally:
            inf.close()
        assert st["rejected"] == len(shed)
        assert st["accepted"] == len(admitted) and st["pending"] == 0


def test_open_breaker_fast_fails_like_jax(mlns):
    """Every dispatch fails (chaos ``hard_rate=1``): the breaker opens and
    the next submit fails ``CircuitOpen`` without touching the queue."""
    results = []
    for inf in _servers(mlns, max_wait_ms=1,
                        chaos=dict(seed=0, hard_rate=1.0),
                        breaker=dict(failure_threshold=0.5, window=8,
                                     min_calls=2, reset_timeout_s=60.0),
                        retry=dict(max_attempts=1)):
        try:
            fails = [_outcome(lambda: inf.submit(features(1, seed=i)))
                     for i in range(2)]
            shed = _outcome(lambda: inf.submit(features(1)))
            st = inf.stats()
        finally:
            inf.close()
        results.append(([f[0] for f in fails], shed[0],
                         st["breaker_state"], st["rejected_circuit"]))
    assert results[1] == results[0] == (
        ["RuntimeError", "RuntimeError"], "CircuitOpen", "open", 1)


def test_breaker_recovers_after_faults_stop(mlns):
    chaos = tres.ChaosPolicy(seed=0, hard_rate=1.0)
    breaker = tres.CircuitBreaker(failure_threshold=0.5, window=8,
                                  min_calls=2, reset_timeout_s=0.2)
    inf = ParallelInference(mlns[1], max_wait_ms=1, chaos=chaos,
                            breaker=breaker,
                            retry=tres.RetryPolicy(max_attempts=1),
                            device="cpu")
    try:
        for i in range(3):
            with pytest.raises(RuntimeError):
                inf.submit(features(1, seed=i)).result(timeout=30)
        chaos.hard_rate = 0.0
        deadline = time.monotonic() + 15
        out = None
        while out is None and time.monotonic() < deadline:
            try:
                out = inf.submit(features(1)).result(timeout=30)
            except (tres.CircuitOpen, RuntimeError):
                time.sleep(0.05)
        assert out is not None and out.shape == (1, 3)
        assert breaker.state == tres.CircuitBreaker.CLOSED
    finally:
        inf.close()


def test_mid_queue_expiry_and_early_flush(mlns):
    """A request stuck behind a slow dispatch expires in the coalescer;
    a member whose budget is shorter than the window flushes early."""
    chaos = tres.ChaosPolicy(seed=0, latency_rate=1.0, latency_s=0.4)
    with ParallelInference(mlns[1], max_wait_ms=1, chaos=chaos,
                           device="cpu") as inf:
        ok = inf.submit(features(1))
        time.sleep(0.1)
        dead = inf.submit(features(1, seed=1), deadline_s=0.05)
        assert ok.result(timeout=30).shape == (1, 3)
        with pytest.raises(tres.DeadlineExceeded):
            dead.result(timeout=30)
    with ParallelInference(mlns[1], max_batch=64, max_wait_ms=10_000,
                           device="cpu") as inf:
        fut = inf.submit(features(1), deadline_s=1.0)
        assert fut.result(timeout=5).shape == (1, 3)


def test_retries_and_retry_budget(mlns):
    """Transient faults under the retry budget resolve to the fault-free
    rows; a fault that never heals surfaces ``TransientDispatchError``.
    One row per forward (``max_batch=1``): how a burst coalesces must not
    decide how many seeded fault draws are made (ROADMAP C6)."""
    retry = tres.RetryPolicy(max_attempts=6, base_s=1e-4, cap_s=1e-3, seed=0)
    chaos = tres.ChaosPolicy(seed=1, transient_rate=0.3)
    with ParallelInference(mlns[1], max_batch=1, max_wait_ms=1, chaos=chaos,
                           breaker=False, retry=retry, device="cpu") as inf:
        ref = inf.output(features(1))
        for f in [inf.submit(features(1)) for _ in range(30)]:
            np.testing.assert_array_equal(f.result(timeout=60), ref)
        assert inf.stats()["retried"] >= 1 and chaos.injected_transient >= 1
    chaos = tres.ChaosPolicy(seed=0, transient_rate=1.0)
    retry = tres.RetryPolicy(max_attempts=3, base_s=1e-4, cap_s=1e-3, seed=0)
    with ParallelInference(mlns[1], max_wait_ms=1, chaos=chaos,
                           breaker=False, retry=retry, device="cpu") as inf:
        with pytest.raises(tres.TransientDispatchError):
            inf.submit(features(1)).result(timeout=30)
        assert inf.stats()["breaker_state"] == "disabled"


# ------------------------------------------------------------- lifecycle
def _staged_behind_sentinel(mod, inf):
    with inf._lock:
        co = inf._ensure_workers()
    co.close(timeout=5)                   # the pool retires at the sentinel
    reqs = [mod._Request(features(1, seed=i), None) for i in range(3)]
    for r in reqs:
        co._inbox.put(r)
    inf.close()
    out = [_outcome(lambda: r.future) for r in reqs]
    return out, co._inbox.empty()


def test_close_fails_requests_queued_behind_sentinel(mlns):
    """Requests a racing submit slipped in behind the shutdown sentinel are
    FAILED by close() with JAX's error, never stranded."""
    import deeplearning4j_tpu.parallel.inference as jmod
    import deeplearning4j_torch.parallel.inference as tmod

    jinf, tinf = _servers(mlns)
    got = _staged_behind_sentinel(tmod, tinf)
    assert got == _staged_behind_sentinel(jmod, jinf)
    assert got == ([("RuntimeError", "ParallelInference is closed")] * 3,
                   True)


def test_submit_racing_close_resolves_future(mlns):
    """A submit whose enqueue lands just as close() runs gets a failed
    future, never a hung one (every worker retired first, close injected
    between the enqueue and the re-check)."""
    from deeplearning4j_torch.parallel import runtime as trt

    inf = ParallelInference(mlns[1], device="cpu")
    with inf._lock:
        co = inf._ensure_workers()
        cm = inf._completer
    for loop in (co, cm):
        for _ in range(loop.alive_workers):
            loop._inbox.put(trt._RESIGN)
    deadline = time.monotonic() + 5
    while (co.alive_workers or cm.alive_workers) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert co.alive_workers == 0 and cm.alive_workers == 0
    orig_put = co.put

    def put_then_close(item, timeout=None):
        orig_put(item, timeout=timeout)
        if not inf._closed:
            inf.close()

    co.put = put_then_close
    fut = inf.submit(features(1))
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError):
        inf.submit(features(1))


def test_drain_completes_inflight_and_rejects_new(mlns):
    chaos = tres.ChaosPolicy(seed=0, latency_rate=1.0, latency_s=0.05)
    inf = ParallelInference(mlns[1], max_batch=2, max_wait_ms=1, chaos=chaos,
                            device="cpu")
    try:
        futs = [inf.submit(features(1, seed=i)) for i in range(6)]
        drainer = {}
        t = threading.Thread(
            target=lambda: drainer.setdefault("ok", inf.drain(timeout=60)))
        t.start()
        time.sleep(0.01)
        with pytest.raises(RuntimeError, match="draining"):
            inf.submit(features(1))
        t.join(70)
        assert not t.is_alive() and drainer["ok"] is True
        for f in futs:
            assert f.result(timeout=1).shape == (1, 3)
        assert inf.stats()["pending"] == 0
    finally:
        inf.close()


def test_multithreaded_submitters_and_monotone_stats(mlns):
    """Submissions racing from 24 threads all resolve to their own rows,
    while a reader's ``stats()["dispatches"]`` never goes backwards."""
    x = features(24, seed=4)
    results, snapshots = {}, []
    stop = threading.Event()
    with ParallelInference(mlns[1], max_wait_ms=20, device="cpu") as inf:
        ref = inf.output(x)

        def reader():
            while not stop.is_set():
                snapshots.append(inf.stats()["dispatches"])

        def worker(i):
            results[i] = inf.submit(x[i:i + 1]).result(timeout=30)

        r = threading.Thread(target=reader, daemon=True)
        r.start()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        r.join(10)
        assert not any(t.is_alive() for t in threads)
        final = inf.stats()
    for i in range(24):
        np.testing.assert_allclose(results[i], ref[i:i + 1], rtol=0,
                                   atol=ATOL)
    assert final["completed"] == 24
    assert snapshots == sorted(snapshots)


def test_coalescer_pool_scales(mlns):
    """``set_coalescer_workers`` (the autoscaler's lever) clamps to
    [1, max_coalescers] and the pool follows; rows stay right."""
    x = features(8, seed=9)
    with ParallelInference(mlns[1], max_wait_ms=5, max_coalescers=3,
                           device="cpu") as inf:
        ref = inf.output(x)
        assert inf.coalescer_workers == 1
        _submit_rows(inf, x)
        assert inf.set_coalescer_workers(5) == 3
        deadline = time.monotonic() + 10
        while inf._coalescer.alive_workers != 3 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert inf._coalescer.alive_workers == 3
        np.testing.assert_allclose(_submit_rows(inf, x), ref, rtol=0,
                                   atol=ATOL)
        assert inf.set_coalescer_workers(0) == 1
    assert inf.set_coalescer_workers(2) == 1          # closed: unchanged


def test_chaos_200_submits_zero_lost_futures(mlns):
    """``TestChaosEndToEnd``: 200 submits at 10% transient faults; every
    future resolves with rows equal to ``output()`` or fails typed, none is
    lost, and retries recover at least 95%."""
    chaos = tres.ChaosPolicy(seed=42, transient_rate=0.10)
    retry = tres.RetryPolicy(max_attempts=4, base_s=1e-4, cap_s=2e-3, seed=0)
    typed = (tres.DeadlineExceeded, tres.ServerOverloaded, tres.CircuitOpen,
             tres.TransientDispatchError)
    with ParallelInference(mlns[1], max_batch=16, max_wait_ms=1,
                           max_pending=512, retry=retry, chaos=chaos,
                           device="cpu") as inf:
        ref = inf.output(features(1))
        futs, shed = [], 0
        for _ in range(200):
            try:
                futs.append(inf.submit(features(1)))
            except (tres.ServerOverloaded, tres.CircuitOpen):
                shed += 1
        resolved = failed = 0
        for f in futs:
            try:
                np.testing.assert_allclose(f.result(timeout=120), ref,
                                           rtol=0, atol=ATOL)
                resolved += 1
            except typed:
                failed += 1
        st = inf.stats()
    assert resolved + failed + shed == 200
    assert st["pending"] == 0 and st["completed"] == resolved
    assert chaos.injected_transient > 0
    assert resolved >= 0.95 * len(futs)


def test_registry_families_equal_jax(mlns):
    """The ``inference_*`` families a scrape shows are JAX's, with the
    same values after the same deterministic traffic."""
    from deeplearning4j_tpu.metrics.exposition import render_text as jrender
    from deeplearning4j_torch.metrics.exposition import render_text

    x = features(8, seed=5)
    texts = []
    for inf, render in zip(_servers(mlns, max_batch=8, max_wait_ms=10_000),
                           (jrender, render_text)):
        try:
            _submit_rows(inf, x)
        finally:
            inf.close()
        lines = render([({}, inf.metrics)]).splitlines()
        texts.append([ln for ln in lines if "latency" not in ln])
    assert texts[1] == texts[0]
    assert "inference_dispatches_total 1" in texts[1]
