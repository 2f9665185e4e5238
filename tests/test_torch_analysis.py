"""graftcheck on the port (``deeplearning4j_torch/analysis/``), on the CPU:
the counterparts of ``tests/test_analysis.py`` (the gate over the port's
tree, the baseline contract, the rule families' positives and negatives,
the ratchet, the seeded cycle, ``OrderedLock``/``OrderedCondition`` and
install/uninstall), parity with the JAX package's analyzer (its fixtures
and its whole tree under the concurrency rules, its host-sync fixture, the
instrument's ranks), the torch rule family's own fixtures, the tripwire
that keeps the trace rules unneeded, the CLI and the ``lock_debug`` plugin,
and a lock-checked serve: a two-replica fleet, a k-NN server and a broker
round under four client threads each, with every serving lock rank-checked,
no violation, and results equal to an uninstrumented run.

Each tree is scanned once per module (a whole-package scan takes seconds).
"""

import ast
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_torch  # noqa: E402
import deeplearning4j_tpu  # noqa: E402
from deeplearning4j_torch.analysis import (Baseline, analyze,  # noqa: E402
                                           concurrency_rules, instrument,
                                           run_check)
from deeplearning4j_torch.analysis.__main__ import main as cli  # noqa: E402
from deeplearning4j_torch.analysis.instrument import (  # noqa: E402
    LockOrderViolation, OrderedCondition, OrderedLock)
from deeplearning4j_tpu.analysis import analyze as jax_analyze  # noqa: E402
from deeplearning4j_tpu.analysis import (  # noqa: E402
    concurrency_rules as jax_concurrency_rules)
from deeplearning4j_tpu.analysis import instrument as jax_instrument  # noqa
from tests.test_torch_knn import assert_knn_close  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.analysis]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures", "analysis")
TORCH_FIXTURES = os.path.join(HERE, "fixtures", "analysis_torch")
PKG = os.path.dirname(os.path.abspath(deeplearning4j_torch.__file__))
JAX_PKG = os.path.dirname(os.path.abspath(deeplearning4j_tpu.__file__))
#: the shipped baseline's size: lowering it is the only allowed edit
BASELINE_CEILING = 7


def _scan(*names, baseline=None, where=FIXTURES):
    files = [os.path.join(where, n) for n in names]
    return analyze(root=where, files=files, baseline=baseline)


def _rows(report):
    return {(f.rule, f.scope, f.detail, f.line) for f in report.findings}


@pytest.fixture(scope="module")
def port_report():
    return run_check()


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX package's modules, parsed once, as ``analyze`` pairs them."""
    base = os.path.dirname(JAX_PKG)
    mods = []
    for dirpath, dirnames, filenames in os.walk(JAX_PKG):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".cache")]
        for name in sorted(filenames):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    mods.append((os.path.relpath(path, base).replace(
                        os.sep, "/"), ast.parse(fh.read())))
    return sorted(mods)


# ---------------------------------------------------------------------------
# the gate: the port's tree analyzes clean against its audited baseline
# ---------------------------------------------------------------------------

def test_gate_zero_unbaselined_findings(port_report):
    rep = port_report
    assert rep.parse_errors == []
    assert [f.render() for f in rep.unbaselined] == []
    assert rep.stale_baseline == []
    assert rep.files_scanned > 100  # the whole package was actually walked


def test_server_stats_lock_discipline_is_clean():
    rep = analyze(root=PKG,
                  files=[os.path.join(PKG, "modelimport", "server.py")])
    mixed = [f for f in rep.findings
             if f.rule == "conc-mixed-lock" and f.scope == "KerasBackendServer"]
    assert mixed == []


def test_repaired_findings_stay_repaired(port_report):
    # the loop-owned declarations, the gauges registered in __init__, the
    # FleetHost._closing discipline and the dropped _snapshot_slot casts:
    # none of those spots flags, under either rule family
    keys = {f.key for f in port_report.findings}
    for attr in ("_state", "_closed_evt", "_supervisor", "_inbox"):
        assert ("conc-mixed-lock::deeplearning4j_torch/parallel/runtime.py"
                f"::ServingLoop::{attr}") not in keys
    for attr in ("_slot_req", "_n_active", "_active_cap", "_queue"):
        assert ("conc-mixed-lock::deeplearning4j_torch/parallel/"
                f"generation.py::GenerationServer::{attr}") not in keys
    assert ("conc-mixed-lock::deeplearning4j_torch/parallel/federation.py"
            "::FleetHost::_closing") not in keys
    assert not any("_snapshot_slot" in k or ":int():" in k for k in keys)


# ---------------------------------------------------------------------------
# baseline contract
# ---------------------------------------------------------------------------

def test_baseline_entry_requires_justification(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(
        {"entries": [{"key": "r::p::s::d", "justification": "   "}]}),
        encoding="utf-8")
    with pytest.raises(ValueError, match="justification"):
        Baseline.load(str(p))


def test_baseline_entry_requires_key(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"entries": [{"justification": "why"}]}),
                 encoding="utf-8")
    with pytest.raises(ValueError, match="key"):
        Baseline.load(str(p))


def test_stale_baseline_entries_are_reported():
    bl = Baseline(entries={"no-such-rule::x.py::S::d": "obsolete"})
    rep = _scan("conc_neg.py", baseline=bl)
    assert rep.stale_baseline == ["no-such-rule::x.py::S::d"]


def test_baseline_splits_findings():
    rep = _scan("conc_pos.py")
    key = next(f.key for f in rep.findings if f.rule == "conc-mixed-lock")
    rep2 = _scan("conc_pos.py", baseline=Baseline(entries={key: "audited"}))
    assert [f.key for f in rep2.baselined] == [key]
    assert key not in {f.key for f in rep2.unbaselined}
    assert len(rep2.unbaselined) == len(rep.findings) - 1


# ---------------------------------------------------------------------------
# torch rule family: positives (must flag) and negatives (must not)
# ---------------------------------------------------------------------------

def test_torch_rules_positives():
    rep = _scan("torch_pos.py", where=TORCH_FIXTURES)
    got = {(f.rule, f.detail) for f in rep.findings}
    sync = {d for (r, d) in got if r == "torch-host-sync-in-hot-loop"}
    # JAX's forms and torch's own device->host syncs
    assert sync == {
        "_decode_once:.cpu():1", "_decode_once:.tolist():1",
        "_decode_once:.numpy():1",
        "_decode_once:torch.cuda.synchronize():1",
        "_decode_once:.item():1", "_decode_once:float():1",
        "_decode_once:np.asarray:1",
        "_run_block:.cpu():1", "_run_block:.cpu():2",
        "_run_block:torch.cuda.synchronize():1"}
    rand = {d for (r, d) in got if r == "torch-global-randomness"}
    assert rand == {
        f"global_torch_draws:{d}" for d in (
            "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
            "torch.multinomial", "torch.bernoulli", "torch.normal",
            "t.uniform_", "t.normal_", "t.bernoulli_", "t.random_",
            "torch.nn.init.normal_")} | {
        f"global_host_draws:{d}" for d in (
            "np.random.randn", "np.random.shuffle", "random.random",
            "random.choice", "np.random.default_rng", "random.Random")}
    assert {f.rule for f in rep.findings} == {
        "torch-host-sync-in-hot-loop", "torch-global-randomness"}


def test_torch_rules_negatives():
    # keyed ops.random under the bare name `random`, seeded generators,
    # host copies off the hot list, and hot-loop code that never syncs
    rep = _scan("torch_neg.py", where=TORCH_FIXTURES)
    assert [f.render() for f in rep.findings] == []


def test_host_sync_flags_jax_decode_once_forms():
    # JAX's host-sync fixture: the port's rule flags JAX's three details
    rep = _scan("jax_pos.py")
    sync = {f.detail for f in rep.findings
            if f.rule == "torch-host-sync-in-hot-loop"}
    assert {"_decode_once:.item():1", "_decode_once:float():1",
            "_decode_once:np.asarray:1"} <= sync


def test_no_trace_rules_without_capture():
    # the port has no jax-retrace/varying-capture/donation counterparts
    # because it captures nothing: no torch.compile, torch.jit or CUDA
    # graph anywhere in the package (the change that adds capture adds
    # the counterpart rule)
    banned = re.compile(r"^torch\.(compile|jit(\..*)?|cuda\.(graph|graphs|"
                        r"CUDAGraph|make_graphed_callables)(\..*)?)$")
    hits = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                parts = []
                cur = node
                while isinstance(cur, ast.Attribute):
                    parts.append(cur.attr)
                    cur = cur.value
                if isinstance(cur, ast.Name) and parts:
                    dn = ".".join([cur.id] + parts[::-1])
                    if banned.match(dn):
                        hits.append(f"{path}:{node.lineno}: {dn}")
                if isinstance(node, ast.ImportFrom) and node.module and (
                        node.module.startswith("torch.jit")
                        or node.module.startswith("torch._dynamo")
                        or node.module == "torch.cuda.graphs"):
                    hits.append(f"{path}:{node.lineno}: {node.module}")
                if isinstance(node, ast.ImportFrom) \
                        and node.module == "torch" \
                        and any(a.name in ("compile", "jit")
                                for a in node.names):
                    hits.append(f"{path}:{node.lineno}: from torch import")
    assert hits == []


# ---------------------------------------------------------------------------
# concurrency rule family: positives and negatives
# ---------------------------------------------------------------------------

def test_concurrency_rules_positives():
    rep = _scan("conc_pos.py")
    mixed = {f.detail for f in rep.findings if f.rule == "conc-mixed-lock"}
    assert mixed == {"_count", "_state", "_items"}

    blocking = {f.detail for f in rep.findings
                if f.rule == "conc-lock-blocking-call"}
    assert blocking == {"wait_result:.result()",
                        "pull:.get() on queue `work_q`",
                        "cross_wait:.wait() on `other_cv`",
                        "nap:time.sleep()"}

    mono = {f.detail for f in rep.findings if f.rule == "monotonic-deadline"}
    assert mono == {"expired:time.time()", "wall_loop:time.time()",
                    "wall_assigned:t0"}


def test_concurrency_rules_negatives():
    rep = _scan("conc_neg.py")
    assert [f.render() for f in rep.findings] == []


def test_loop_ownership_positives():
    rep = _scan("loop_pos.py")
    owned = {f.detail for f in rep.findings
             if f.rule == "conc-loop-ownership"}
    assert owned == {"adopt:_slots", "reset:_round", "_bump:_round"}
    assert not any(f.rule == "conc-mixed-lock" for f in rep.findings)


def test_loop_ownership_negatives():
    rep = _scan("loop_neg.py")
    assert [f.render() for f in rep.findings] == []


def test_device_waits_block_under_a_lock(tmp_path):
    # torch's waits on the card next to JAX's block_until_ready
    src = tmp_path / "waits.py"
    src.write_text(
        "import threading\nimport torch\n\n\n"
        "class Server:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def flush(self, ev):\n"
        "        with self._lock:\n"
        "            torch.cuda.synchronize()\n\n"
        "    def wait_event(self, ev):\n"
        "        with self._lock:\n"
        "            ev.synchronize()\n\n"
        "    def outside(self, ev):\n"
        "        ev.synchronize()\n", encoding="utf-8")
    rep = analyze(root=str(tmp_path), files=[str(src)])
    assert {f.detail for f in rep.findings
            if f.rule == "conc-lock-blocking-call"} == {
        "flush:.synchronize()", "wait_event:.synchronize()"}


def test_baseline_only_shrinks():
    # ratchet: the audited debt ceiling is the count this package shipped
    # with (the designed fetches, each justified). New findings must be
    # FIXED, not baselined; lowering this number is the only allowed edit.
    from deeplearning4j_torch.analysis.core import DEFAULT_BASELINE
    bl = Baseline.load(DEFAULT_BASELINE)
    assert len(bl.entries) <= BASELINE_CEILING
    assert all(k.startswith("torch-host-sync-in-hot-loop::")
               for k in bl.entries)


def test_seeded_lock_cycle_names_both_sites():
    rep = _scan("cycle_seed.py")
    cycles = [f for f in rep.findings if f.rule == "conc-lock-cycle"]
    assert len(cycles) == 1
    msg = cycles[0].message
    assert "StreamingBroker._lock" in msg
    assert "GenerationServer._cond" in msg
    sites = re.findall(r"acquired at (analysis/cycle_seed\.py:\d+)", msg)
    assert len(sites) == 2 and sites[0] != sites[1]


# ---------------------------------------------------------------------------
# parity with the JAX package's analyzer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["conc_pos.py", "conc_neg.py",
                                  "loop_pos.py", "loop_neg.py",
                                  "cycle_seed.py"])
def test_fixture_findings_equal_jax(name):
    files = [os.path.join(FIXTURES, name)]
    want = _rows(jax_analyze(root=FIXTURES, files=files))
    assert _rows(analyze(root=FIXTURES, files=files)) == want


def test_concurrency_findings_on_the_jax_tree_equal_jax(jax_tree):
    def run(rules):
        out = []
        for rel, tree in jax_tree:
            out.extend(rules.check_module(tree, rel))
        out.extend(rules.check_lock_graph(jax_tree))
        return {(f.key, f.line, f.message) for f in out}

    assert len(jax_tree) > 100
    assert run(concurrency_rules) == run(jax_concurrency_rules)


def test_instrument_ranks_equal_jax_less_the_trace_lock():
    def ranks(targets):
        return {(cls.__name__, attr): spec
                for cls, attrs in targets.items()
                for attr, spec in attrs.items()}

    want = ranks(jax_instrument._targets())
    del want[("GenerationServer", "_trace_lock")]
    assert ranks(instrument._targets()) == want


# ---------------------------------------------------------------------------
# the CLI and the pytest plugin
# ---------------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    none = str(tmp_path / "none.json")
    assert cli(["--root", TORCH_FIXTURES, "--baseline", none]) == 1
    out = capsys.readouterr().out
    assert "torch-global-randomness" in out and "findings" in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"entries": [{"key": "k"}]}), encoding="utf-8")
    assert cli(["--root", TORCH_FIXTURES, "--baseline", str(bad)]) == 2
    every = tmp_path / "every.json"
    rep = analyze(root=TORCH_FIXTURES)
    every.write_text(json.dumps({"entries": [
        {"key": f.key, "justification": "fixture"}
        for f in rep.findings]}), encoding="utf-8")
    assert cli(["--check", "--list", "--root", TORCH_FIXTURES,
                "--baseline", str(every)]) == 0
    assert "[baselined]" in capsys.readouterr().out


def test_lock_debug_plugin_fails_a_violation_on_a_loop_thread(tmp_path):
    (tmp_path / "test_probe.py").write_text(
        "from deeplearning4j_torch.parallel.resilience import "
        "CircuitBreaker\n"
        "from deeplearning4j_torch.parallel.runtime import ServingLoop\n\n\n"
        "def test_clean():\n"
        "    cb = CircuitBreaker()\n"
        "    with cb._lock:\n"
        "        pass\n\n\n"
        "def test_inverted_on_a_loop():\n"
        "    cb = CircuitBreaker()\n"
        "    box = []\n\n"
        "    def tick():\n"
        "        with cb._lock:\n"
        "            with box[0]._cond:\n"
        "                pass\n"
        "        return False\n"
        "    box.append(ServingLoop('probe', tick=tick))\n"
        "    box[0].start()\n"
        "    box[0].close(timeout=5.0)\n", encoding="utf-8")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "deeplearning4j_torch.analysis.lock_debug",
         "test_probe.py"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "CircuitBreaker._lock" in out and "ServingLoop._cond" in out


# ---------------------------------------------------------------------------
# runtime half: OrderedLock / OrderedCondition
# ---------------------------------------------------------------------------

def test_ordered_lock_ascending_order_ok():
    a, b = OrderedLock(10, "a"), OrderedLock(20, "b")
    with a:
        with b:
            assert b.locked()
    with b:
        pass


def test_ordered_lock_out_of_order_raises():
    a, b = OrderedLock(10, "a"), OrderedLock(20, "b")
    with b:
        with pytest.raises(LockOrderViolation, match="rank"):
            with a:
                pass
    with a:  # failed acquire left the rank stack clean
        pass


def test_ordered_condition_wait_releases_rank():
    cv, low = OrderedCondition(30, "cv"), OrderedLock(10, "low")
    ran = []

    def pred():
        with low:
            ran.append(1)
        return True

    with cv:
        assert cv.wait_for(pred, timeout=1.0)
        cv.notify_all()
    assert ran == [1]
    with cv:
        with pytest.raises(LockOrderViolation):
            with low:
                pass


def test_instrument_install_uninstall():
    from deeplearning4j_torch.parallel.resilience import CircuitBreaker
    instrument.install()
    instrument.install()  # idempotent
    try:
        cb = CircuitBreaker()
        assert isinstance(cb._lock, OrderedLock)
        assert cb in instrument.built() and instrument.unwrapped() == []
        with cb._lock:
            pass
    finally:
        instrument.uninstall()
    cb2 = CircuitBreaker()
    assert not isinstance(cb2._lock, OrderedLock)


# ---------------------------------------------------------------------------
# a lock-checked serve on the CPU
# ---------------------------------------------------------------------------

V = 64
CLIENTS = 4


@pytest.fixture(scope="module")
def lm():
    from deeplearning4j_torch.models.zoo import TransformerLM

    return TransformerLM(num_labels=V, max_length=16, d_model=32, n_heads=4,
                         n_blocks=2, max_cache=64).init(device="cpu")


def _clients(work):
    """Run ``work(i)`` on ``CLIENTS`` threads at once; re-raise the first
    failure."""
    errors, threads = [], []

    def run(i):
        try:
            work(i)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    for i in range(CLIENTS):
        threads.append(threading.Thread(target=run, args=(i,)))
        threads[-1].start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def _serve_rounds(net, held):
    """The fleet, k-NN and broker rounds, each under ``CLIENTS`` threads:
    (streams by request, frames by topic), bitwise by design, and the
    k-NN round apart as ``(points, queries, (distances, ids))``: the
    euclidean distance is the f32 expansion ``‖q‖² − 2q·p + ‖p‖²``, which
    a coalesced batch rounds differently from run to run, so its answers
    are held by the tie rule (``assert_knn_close``). The servers, closed,
    are appended to ``held``."""
    from deeplearning4j_torch.nearestneighbors.server import (
        NearestNeighborsServer)
    from deeplearning4j_torch.parallel.fleet import ReplicaFleet
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.streaming import (NDArrayConsumer,
                                                NDArrayPublisher,
                                                StreamingBroker)

    rs = np.random.RandomState(11)
    reqs = [(rs.randint(1, V, 3 + i % 4).astype(np.int64), 5,
             dict(temperature=0.8, top_k=5, seed=100 + i) if i % 2 else {})
            for i in range(8)]
    streams = {}
    fleet = ReplicaFleet(lambda rid: GenerationServer(
        net, V, slots=2, page_size=8, device="cpu"), replicas=2)
    held.append(fleet)
    try:
        def gen(i):
            for j in range(i, len(reqs), CLIENTS):
                p, n, kw = reqs[j]
                streams[j] = fleet.submit(p, n, **kw).result(
                    timeout=60).tolist()
        _clients(gen)
        st = fleet.stats()
        assert st["deaths"] == 0 and st["completed"] == len(reqs)
    finally:
        fleet.close()

    pts = rs.randn(256, 8).astype(np.float32)
    qs = pts[:32] + 0.01
    answers, distances = {}, {}
    with NearestNeighborsServer(pts, backend="index", device="cpu") as knn:
        held.append(knn)
        def query(i):
            for j in range(i, 32, CLIENTS):
                d, idx = knn.knn(qs[j:j + 1], 3)
                answers[j] = np.asarray(idx).reshape(3)
                distances[j] = np.asarray(d, np.float64).reshape(3)
        _clients(query)
    assert sorted(answers) == list(range(32))
    knn_round = (pts, qs, (np.stack([distances[j] for j in range(32)]),
                           np.stack([answers[j] for j in range(32)])))

    frames = {}
    broker = StreamingBroker(port=0).start()
    held.append(broker)
    try:
        def round_trip(i):
            topic = f"t{i}"
            with NDArrayConsumer("127.0.0.1", broker.port, topic,
                                 idle_timeout_s=30.0) as cons:
                with NDArrayPublisher("127.0.0.1", broker.port,
                                      topic) as pub:
                    for k in range(4):
                        x = np.full((2, 3), 10 * i + k, np.float32)
                        pub.publish_arrays(x, x[:, :1])
                    pub.end()
                frames[topic] = [ds.features.tolist() for ds in cons]
        _clients(round_trip)
    finally:
        broker.close()
    return (streams, frames), knn_round


def _exact_knn(pts, qs, k):
    """The exact k nearest points of each query in f64: (euclidean
    distances, ids), ties to the lower id."""
    d2 = ((qs.astype(np.float64)[:, None, :]
           - pts.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.sqrt(np.take_along_axis(d2, ids, axis=1)), ids


def test_lock_checked_serve_equals_plain_serve(lm):
    plain, plain_d = _serve_rounds(lm, [])
    del instrument.violations[:]
    held = []
    instrument.install()
    try:
        checked, checked_d = _serve_rounds(lm, held)
        built = instrument.built()
        kinds = {type(o).__name__ for o in built}
        loops = [o for o in built if type(o).__name__ == "ServingLoop"]
        unwrapped = instrument.unwrapped()
    finally:
        instrument.uninstall()
    assert instrument.violations == []
    assert unwrapped == []
    assert {"ReplicaFleet", "GenerationServer", "ServingLoop",
            "NearestNeighborsServer", "EmbeddingIndex", "StreamingBroker",
            "AdmissionController", "CircuitBreaker", "RetryPolicy"} <= kinds
    assert loops and all(lp.crashed is None and lp.restarts == 0
                         for lp in loops)
    assert checked == plain
    # k-NN answers by the tie rule: the checked run against the plain one,
    # and each against the exact f64 neighbours of the 256 points
    pts, qs, got = checked_d
    want = plain_d[2]
    assert_knn_close(got, want, pts, qs, "euclidean")
    exact = _exact_knn(pts, qs, 3)
    for answers in (got, want):
        assert_knn_close(answers, exact, pts, qs, "euclidean")
    streams, frames = checked
    assert len(streams) == 8 and got[1].shape == (32, 3)
    assert (got[1][:, 0] == np.arange(32)).all()
    assert frames == {f"t{i}": [[[float(10 * i + k)] * 3] * 2
                                for k in range(4)]
                      for i in range(CLIENTS)}


def test_seeded_out_of_order_acquisition_raises():
    from deeplearning4j_torch.parallel.resilience import CircuitBreaker
    from deeplearning4j_torch.parallel.runtime import ServingLoop

    del instrument.violations[:]
    instrument.install()
    try:
        cb = CircuitBreaker()
        box = []

        def tick():
            # rank 70 held, rank 25 taken: the loop's thread raises
            with cb._lock:
                with box[0]._cond:
                    pass
            return False

        box.append(ServingLoop("seeded", tick=tick))
        box[0].start()
        box[0].close(timeout=10.0)
        crash = box[0].crashed
        with pytest.raises(LockOrderViolation, match="CircuitBreaker._lock"):
            with cb._lock:   # and in the caller's own thread
                with box[0]._cond:
                    pass
    finally:
        instrument.uninstall()
    assert isinstance(crash, LockOrderViolation)
    assert "CircuitBreaker._lock" in str(crash)
    assert "ServingLoop._cond" in str(crash)
    assert len(instrument.violations) == 2
    del instrument.violations[:]
