"""The port's elastic training (``deeplearning4j_torch/parallel/elastic.py``)
on the CPU: the counterpart of every test in ``tests/test_elastic.py``.

Both packages' nets start from the JAX net's weights (``params_from_jax``)
and see the same numpy batches. A crashed-and-resumed port run equals the
port's uninterrupted run bit for bit (as JAX's test holds its own), and
equals JAX's ``FaultTolerantTrainer`` after the same crash within JAX's
Adam tolerance (rtol 1e-4 / atol 1e-5, ROADMAP C5). The subprocess
kill-and-resume test is slow; the in-process crash through
``FaultInjectionListener`` is its tier-1 sibling.
"""

import json
import os
import subprocess
import sys
import threading
import time
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator)
from deeplearning4j_torch.nn.conf.builders import (  # noqa: E402
    NeuralNetConfiguration)
from deeplearning4j_torch.nn.conf.inputs import InputType  # noqa: E402
from deeplearning4j_torch.nn.conf.layers.core import (  # noqa: E402
    DenseLayer, OutputLayer)
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_torch.nn.updater import Adam  # noqa: E402
import deeplearning4j_torch.parallel.elastic as el  # noqa: E402
from deeplearning4j_torch.parallel.elastic import (  # noqa: E402
    CheckpointListener, CheckpointStore, FailureDetector,
    FaultInjectionListener, FaultTolerantTrainer, Heartbeat)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

#: JAX's Adam tolerance between the packages (ROADMAP C5)
RTOL, ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _conf(seed):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(learning_rate=0.01))
            .list(DenseLayer(n_out=16, activation="relu"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())


def _jax_net(seed=12345):
    from deeplearning4j_tpu.nn.conf.builders import (
        NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JInput
    from deeplearning4j_tpu.nn.conf.layers.core import (
        DenseLayer as JDense, OutputLayer as JOut)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updater import Adam as JAdam

    conf = (JConf.builder().seed(seed).updater(JAdam(learning_rate=0.01))
            .list(JDense(n_out=16, activation="relu"),
                  JOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInput.feed_forward(4)).build())
    return JMLN(conf).init()


def _host(tree):
    return {k: {n: np.asarray(v) for n, v in p.items()}
            for k, p in tree.items()}


@pytest.fixture(scope="module")
def jax_params():
    """The JAX ``_net()``'s initial weights, as numpy."""
    return _host(_jax_net().params)


def _net(params, seed=12345):
    """The port's counterpart of ``tests/test_elastic.py::_net``, on the
    JAX net's weights."""
    net = MultiLayerNetwork(_conf(seed)).init(device="cpu")
    params_from_jax(params, net)
    return net


def _batches(n=12, batch=16, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(batch, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, batch)]
        out.append(DataSet(x, y))
    return out


def _flat(net):
    return np.asarray(net.params_flat(), np.float32)


def _baseline(params, batches, epochs):
    base = _net(params)
    for _ in range(epochs):
        for ds in batches:
            base._fit_batch(ds)
    return base


# ------------------------------------------------------- checkpoint store
class TestCheckpointStore:
    def test_roundtrip_and_prune(self, tmp_path, jax_params):
        store = CheckpointStore(str(tmp_path), keep=2)
        net = _net(jax_params)
        data = _batches(1)[0]
        for _ in range(4):
            net.fit(data)
            store.save(net, {"epoch": net.epoch, "batch_in_epoch": 0})
        assert len(store.checkpoints()) == 2   # pruned to keep=2
        restored, meta = store.restore(device="cpu")
        assert restored.iteration == net.iteration
        np.testing.assert_array_equal(_flat(restored), _flat(net))

    def test_corrupt_checkpoint_quarantined(self, tmp_path, jax_params):
        store = CheckpointStore(str(tmp_path), keep=5)
        net = _net(jax_params)
        data = _batches(1)[0]
        net.fit(data)
        good = store.save(net)
        net.fit(data)
        bad = store.save(net)
        raw = open(bad, "rb").read()
        with open(bad, "wb") as fh:
            fh.write(raw[:len(raw) // 2])
        with pytest.warns(UserWarning, match="quarantining"):
            assert store.latest() == good
        assert os.path.exists(bad + ".corrupt")
        restored, _ = store.restore(device="cpu")
        assert restored.iteration == 1

    def test_transient_oserror_does_not_quarantine(self, tmp_path,
                                                   monkeypatch, jax_params):
        store = CheckpointStore(str(tmp_path), keep=5)
        net = _net(jax_params)
        net.fit(_batches(1)[0])
        path = store.save(net)
        real_zip = zipfile.ZipFile

        def flaky_zip(p, *a, **kw):
            raise OSError("transient read failure")

        monkeypatch.setattr(zipfile, "ZipFile", flaky_zip)
        with pytest.warns(UserWarning, match="transient"):
            assert store.latest() is None
        monkeypatch.setattr(zipfile, "ZipFile", real_zip)
        assert not os.path.exists(path + ".corrupt")
        assert store.latest() == path

    def test_restore_falls_back_when_newest_vanishes_midread(
            self, tmp_path, monkeypatch, jax_params):
        store = CheckpointStore(str(tmp_path), keep=5)
        net = _net(jax_params)
        ds = _batches(1)[0]
        net.fit(ds)
        p1 = store.save(net)
        net.fit(ds)
        p2 = store.save(net)
        real = el.load_model

        def racy(path, device=None):
            if path == p2:
                os.unlink(p2)   # a concurrent pruner strikes mid-read
                raise OSError("gone")
            return real(path, device=device)

        monkeypatch.setattr(el, "load_model", racy)
        with pytest.warns(UserWarning, match="trying next-older"):
            restored, _ = store.restore(device="cpu")
        monkeypatch.setattr(el, "load_model", real)
        assert restored.iteration == 1
        restored.fit(ds)
        assert store.save(restored) == p2
        r2, _ = store.restore(device="cpu")
        assert r2.iteration == 2

    def test_restore_raises_when_all_checkpoints_unloadable(
            self, tmp_path, monkeypatch, jax_params):
        store = CheckpointStore(str(tmp_path))
        net = _net(jax_params)
        net.fit(_batches(1)[0])
        store.save(net)

        def broken(path, device=None):
            raise KeyError("metadata.json")

        monkeypatch.setattr(el, "load_model", broken)
        with pytest.warns(UserWarning), \
                pytest.raises(RuntimeError, match="refusing to silently"):
            store.restore(device="cpu")

    def test_atomic_save_never_leaves_partial(self, tmp_path, jax_params):
        store = CheckpointStore(str(tmp_path))
        net = _net(jax_params)
        net.fit(_batches(1)[0])
        store.save(net)
        names = os.listdir(tmp_path)
        assert all(n.startswith("ckpt-") and n.endswith(".zip")
                   for n in names), names


class TestCheckpointListener:
    def test_saves_on_frequency(self, tmp_path, jax_params):
        store = CheckpointStore(str(tmp_path), keep=10)
        net = _net(jax_params)
        listener = CheckpointListener(store, frequency=3)
        net.set_listeners(listener)
        net.fit(ListDataSetIterator(_batches(7), batch_size=16))
        assert listener.saved == 2   # iterations 3 and 6
        assert len(store.checkpoints()) == 2


# ------------------------------------------------- fault-tolerant trainer
@pytest.fixture(scope="module")
def jax_resumed(jax_params, tmp_path_factory):
    """JAX's crash at iteration 7 of 12 and resume through its own
    ``FaultTolerantTrainer``: (final iteration, final params)."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import (
        ListDataSetIterator as JList)
    from deeplearning4j_tpu.parallel import elastic as jel

    batches = [JDataSet(d.features, d.labels) for d in _batches(6)]
    factory = lambda: JList(list(batches), batch_size=16)  # noqa: E731
    store = jel.CheckpointStore(str(tmp_path_factory.mktemp("jax_ckpt")),
                                keep=5)
    net = _jax_net()
    net.set_listeners(jel.FaultInjectionListener(at_iteration=7))
    with pytest.raises(jel.FaultInjectionListener.InjectedFault):
        jel.FaultTolerantTrainer(net, store, frequency=2).run(factory,
                                                              epochs=2)
    net2 = _jax_net(seed=999)
    net2.set_listeners()
    final = jel.FaultTolerantTrainer(net2, store, frequency=2).run(
        factory, epochs=2)
    return final.iteration, np.asarray(final.params_flat(), np.float32)


class TestFaultTolerantTrainer:
    def test_resume_equals_uninterrupted(self, tmp_path, jax_params,
                                         jax_resumed):
        """Crash at iteration 7 (epoch 1, batch 1) through the fault
        listener, resume in a fresh trainer around a throwaway net: the
        port's result equals its uninterrupted run bit for bit, and JAX's
        resumed run within JAX's Adam tolerance."""
        batches = _batches(6)
        factory = lambda: ListDataSetIterator(list(batches),  # noqa: E731
                                              batch_size=16)
        base = _baseline(jax_params, batches, 2)

        net = _net(jax_params)
        net.set_listeners(FaultInjectionListener(at_iteration=7))
        store = CheckpointStore(str(tmp_path), keep=5)
        with pytest.raises(FaultInjectionListener.InjectedFault):
            FaultTolerantTrainer(net, store, frequency=2).run(factory,
                                                              epochs=2)
        assert store.latest() is not None

        net2 = _net(jax_params, seed=999)
        net2.set_listeners()
        for p in net2.params.values():          # wrong weights on purpose:
            for t in p.values():                # run() must replace them
                t.data.fill_(0.5)
        final = FaultTolerantTrainer(net2, store, frequency=2).run(
            factory, epochs=2)
        assert final.device.type == "cpu"
        assert final.iteration == base.iteration == 12
        np.testing.assert_array_equal(_flat(final), _flat(base))
        j_iter, j_flat = jax_resumed
        assert final.iteration == j_iter
        np.testing.assert_allclose(_flat(final), j_flat, rtol=RTOL,
                                   atol=ATOL)

    def test_skip_spill_into_next_epoch_warns(self, tmp_path, jax_params):
        store = CheckpointStore(str(tmp_path))
        trainer = FaultTolerantTrainer(_net(jax_params), store,
                                       frequency=100)
        batches = _batches(2)
        factory = lambda: ListDataSetIterator(list(batches),  # noqa: E731
                                              batch_size=16)
        with pytest.warns(UserWarning, match="iterator_factory"):
            trainer.fit(factory, epochs=2, skip_batches=3)
        assert trainer.net.iteration == 2   # skips dropped, not spilled

    def test_completed_run_not_retrained(self, tmp_path, jax_params):
        batches = _batches(3)
        factory = lambda: ListDataSetIterator(list(batches),  # noqa: E731
                                              batch_size=16)
        store = CheckpointStore(str(tmp_path))
        done = FaultTolerantTrainer(_net(jax_params), store,
                                    frequency=2).run(factory, epochs=1)
        it_before = done.iteration
        final = FaultTolerantTrainer(_net(jax_params, seed=7), store,
                                     frequency=2).run(factory, epochs=1)
        assert final.iteration == it_before == 3
        np.testing.assert_array_equal(_flat(final), _flat(done))


_SUBPROCESS_SCRIPT = r"""
import os, sys
import numpy as np
import torch

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers.core import DenseLayer, OutputLayer
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.nn.updater import Adam
from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.parallel.elastic import (CheckpointStore,
                                                   FaultTolerantTrainer)
from deeplearning4j_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ckpt_dir, crash_at, weights = sys.argv[1], int(sys.argv[2]), sys.argv[3]

conf = (NeuralNetConfiguration.builder().seed(12345)
        .updater(Adam(learning_rate=0.01))
        .list(DenseLayer(n_out=16, activation="relu"),
              OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(4)).build())
net = MultiLayerNetwork(conf).init(device="cpu")
with np.load(weights) as z:
    params = {}
    for key in z.files:
        layer, name = key.split("/")
        params.setdefault(layer, {})[name] = z[key]
params_from_jax(params, net)

rs = np.random.RandomState(0)
batches = [DataSet(rs.randn(16, 4).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)])
           for _ in range(6)]
factory = lambda: ListDataSetIterator(list(batches), batch_size=16)


class HardKill(TrainingListener):
    def iteration_done(self, model, iteration):
        if iteration == crash_at:
            os._exit(137)  # a simulated SIGKILL: no cleanup, no atexit


if crash_at > 0:
    net.set_listeners(HardKill())
trainer = FaultTolerantTrainer(net, CheckpointStore(ckpt_dir, keep=3),
                               frequency=2)
final = trainer.run(factory, epochs=2)
np.save(os.path.join(ckpt_dir, "final.npy"),
        np.asarray(final.params_flat(), np.float32))
print("FINAL", final.iteration, "jax" in sys.modules)
"""


@pytest.mark.slow
class TestProcessKillRecovery:
    def test_kill_and_resume_subprocess(self, tmp_path, jax_params):
        """Run 1 dies with ``os._exit(137)`` at iteration 7 of 12; run 2,
        the same command, resumes from its checkpoint; run 3 runs
        uninterrupted in a fresh directory. Runs 2 and 3 end at the same
        iteration with equal weights, and no child imports JAX."""
        script = tmp_path / "train.py"
        script.write_text(_SUBPROCESS_SCRIPT)
        weights = str(tmp_path / "weights.npz")
        np.savez(weights, **{f"{k}/{n}": v for k, p in jax_params.items()
                             for n, v in p.items()})
        ckpt, ckpt2 = str(tmp_path / "ckpts"), str(tmp_path / "ckpts2")
        env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", "")}

        def run(directory, crash_at):
            return subprocess.run(
                [sys.executable, str(script), directory, str(crash_at),
                 weights], capture_output=True, text=True, env=env,
                timeout=300)

        p1 = run(ckpt, 7)
        assert p1.returncode == 137, p1.stderr
        p2 = run(ckpt, 0)
        assert p2.returncode == 0, p2.stderr
        p3 = run(ckpt2, 0)
        assert p3.returncode == 0, p3.stderr
        line = [ln for ln in p2.stdout.splitlines()
                if ln.startswith("FINAL")][0].split()
        ref = [ln for ln in p3.stdout.splitlines()
               if ln.startswith("FINAL")][0].split()
        assert line[1] == ref[1] == "12"   # 2 epochs x 6 batches, no repeat
        assert line[2] == ref[2] == "False"
        np.testing.assert_array_equal(
            np.load(os.path.join(ckpt, "final.npy")),
            np.load(os.path.join(ckpt2, "final.npy")))


class TestEmergencyCheckpoint:
    def test_crash_writes_emergency_checkpoint(self, tmp_path, jax_params):
        batches = _batches(6)
        factory = lambda: ListDataSetIterator(list(batches),  # noqa: E731
                                              batch_size=16)
        base = _baseline(jax_params, batches, 1)

        store = CheckpointStore(str(tmp_path), keep=5)
        net = _net(jax_params)
        net.set_listeners(FaultInjectionListener(at_iteration=3))
        trainer = FaultTolerantTrainer(net, store, frequency=10_000)
        with pytest.raises(FaultInjectionListener.InjectedFault):
            trainer.fit(factory, epochs=1)
        restored, meta = store.restore(device="cpu")
        assert meta["emergency"] is True
        assert "InjectedFault" in meta["error"]
        # the listener raised after iteration 3's update: the batch in
        # flight counts as trained, so the resume starts at batch 3
        assert meta["epoch"] == 0 and meta["batch_in_epoch"] == 3
        assert restored.iteration == 3

        final = FaultTolerantTrainer(_net(jax_params, seed=9), store,
                                     frequency=10_000).run(factory,
                                                           epochs=1)
        assert final.iteration == base.iteration == 6
        np.testing.assert_array_equal(_flat(final), _flat(base))

    def test_emergency_save_failure_never_masks_original(self, tmp_path,
                                                         monkeypatch,
                                                         jax_params):
        store = CheckpointStore(str(tmp_path))
        net = _net(jax_params)
        net.set_listeners(FaultInjectionListener(at_iteration=2))
        trainer = FaultTolerantTrainer(net, store, frequency=10_000)

        def broken_save(*a, **kw):
            raise OSError("disk full")

        monkeypatch.setattr(store, "save", broken_save)
        factory = lambda: ListDataSetIterator(_batches(4),  # noqa: E731
                                              batch_size=16)
        with pytest.warns(UserWarning, match="emergency checkpoint failed"), \
                pytest.raises(FaultInjectionListener.InjectedFault):
            trainer.fit(factory, epochs=1)


# ------------------------------------------------------ failure detection
class TestFailureDetection:
    def test_heartbeat_and_stall_detection(self, tmp_path):
        alive = Heartbeat(str(tmp_path / "w0.heartbeat"), interval=0.2)
        alive.start()
        (tmp_path / "w1.heartbeat").write_text(
            json.dumps({"pid": 99999, "ts": time.time() - 100}))
        (tmp_path / "w2.heartbeat").write_text("{\"pid\": 3")
        try:
            det = FailureDetector(str(tmp_path), timeout=1.0)
            assert set(det.workers()) == {"w0", "w1", "w2"}
            # an unreadable file is dead at once; a stale readable ts needs
            # two scans before it ages out on the observer's clock
            assert det.dead_workers() == ["w2"]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                dead = det.dead_workers()
                if dead == ["w1", "w2"]:
                    break
                time.sleep(0.05)
            assert dead == ["w1", "w2"]   # w0 keeps beating
        finally:
            alive.stop()

    def test_heartbeat_survives_transient_oserror(self, tmp_path):
        hb = Heartbeat(str(tmp_path / "w.heartbeat"), interval=0.005)
        real_beat = hb.beat
        failing = threading.Event()

        def flaky_beat():
            if failing.is_set():
                raise OSError("disk full")
            real_beat()

        hb.beat = flaky_beat
        hb.start()   # the first beat succeeds
        try:
            failing.set()
            deadline = time.time() + 10
            while time.time() < deadline and not hb._warned:
                time.sleep(0.01)
            assert hb._warned
            assert hb.consecutive_failures >= Heartbeat.WARN_AFTER_FAILURES
            assert hb._thread.is_alive()
            failing.clear()
            deadline = time.time() + 10
            while time.time() < deadline and hb.consecutive_failures:
                time.sleep(0.01)
            assert hb.consecutive_failures == 0
            assert not hb._warned
            assert hb._thread.is_alive()
        finally:
            hb.stop()

    def test_heartbeat_initial_beat_still_fails_fast(self, tmp_path):
        hb = Heartbeat(str(tmp_path / "no" / "such" / "dir" / "w.heartbeat"),
                       interval=0.01)
        with pytest.raises(OSError):
            hb.start()

    def test_wedged_worker_ages_out(self, tmp_path):
        hb = Heartbeat(str(tmp_path / "w.heartbeat"), interval=60)
        hb.beat()   # one beat, then the worker wedges
        det = FailureDetector(str(tmp_path), timeout=5.0)
        assert det.dead_workers() == []
        assert det.dead_workers(now=time.monotonic() + 30) == ["w"]

    def test_wall_clock_jump_does_not_expire_fresh_lease(self, tmp_path,
                                                         monkeypatch):
        hb = Heartbeat(str(tmp_path / "w.heartbeat"), interval=60)
        hb.beat()
        det = FailureDetector(str(tmp_path), timeout=5.0)
        assert det.dead_workers() == []
        real_time = time.time
        # the observer's wall clock jumps 2 h forward
        monkeypatch.setattr(time, "time", lambda: real_time() + 7200.0)
        assert det.dead_workers() == []
        hb.beat()    # the writer's jumps too: a new version, alive
        assert det.dead_workers() == []
        monkeypatch.setattr(time, "time", lambda: real_time() - 7200.0)
        hb.beat()    # a backward step is a new version as well
        assert det.dead_workers() == []

    def test_detectors_agree_with_jax(self, tmp_path):
        """The port's detector and JAX's read one directory of heartbeat
        files (a fresh one, a stale one, a torn one, a stray file) to the
        same workers and the same verdicts under the same ``now``."""
        from deeplearning4j_tpu.parallel.elastic import (
            FailureDetector as JDetector, Heartbeat as JHeartbeat)

        Heartbeat(str(tmp_path / "a.heartbeat")).beat()
        JHeartbeat(str(tmp_path / "b.heartbeat")).beat()
        (tmp_path / "c.heartbeat").write_text("{")
        (tmp_path / "notes.txt").write_text("x")
        ours, theirs = (FailureDetector(str(tmp_path), timeout=5.0),
                        JDetector(str(tmp_path), timeout=5.0))
        t0 = time.monotonic()
        assert ours.workers() == theirs.workers()
        for now in (t0, t0 + 1.0, t0 + 30.0):
            assert ours.dead_workers(now=now) == \
                theirs.dead_workers(now=now)
        assert ours.dead_workers(now=t0 + 30.0) == ["a", "b", "c"]


class TestDerivedResume:
    def test_bare_listener_checkpoint_resumes_without_double_training(
            self, tmp_path, jax_params):
        """A bare ``CheckpointListener``'s checkpoints carry no position:
        ``run()`` derives it from the iteration count and the stream
        length. The crashing net trains through the fused fit (K = 2 on
        the CPU), which equals the per-batch reference only to rounding;
        training a batch twice would differ by ~1e-3."""
        batches = _batches(6)
        factory = lambda: ListDataSetIterator(list(batches),  # noqa: E731
                                              batch_size=16)
        base = _baseline(jax_params, batches, 2)

        store = CheckpointStore(str(tmp_path), keep=5)
        net = _net(jax_params)
        net.set_listeners(CheckpointListener(store, frequency=4),
                          FaultInjectionListener(at_iteration=8))
        with pytest.raises(FaultInjectionListener.InjectedFault):
            net.fit(factory(), epochs=2)

        resumed = FaultTolerantTrainer(_net(jax_params, seed=3), store,
                                       frequency=4)
        with pytest.warns(UserWarning, match="derived resume point"):
            final = resumed.run(factory, epochs=2)
        assert final.iteration == base.iteration
        np.testing.assert_allclose(_flat(final), _flat(base), rtol=0,
                                   atol=5e-6)
