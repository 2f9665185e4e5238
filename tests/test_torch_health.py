"""The port's numerical-health guard (``optimize/health.py``, the guarded
step of ``optimize/fused_fit.py``, ``parallel/elastic.py``'s checkpoint
store), on the CPU: the cases of ``tests/test_health.py`` on the graph net,
and the ladder held to JAX's ``HealthPolicy``.

In eager PyTorch the guarded step runs the unguarded step's operations
plus a select that returns the new trees exactly on a finite step, so
guard-on equals guard-off BIT FOR BIT on clean data, and a NaN batch
mid-stream gives the same params fused (K = 4) as unfused (JAX bounds both
by ``TOL``). A skipped step leaves params, updater state and layer state
bit for bit unchanged; under Sgd a skipped batch equals a batch never
seen. The recovery ladder emits JAX's events, in JAX's order, on the same
score/skip stream. The ParallelWrapper cases wait for its port (ROADMAP
A11c).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator)
from deeplearning4j_torch.nn.conf.builders import (  # noqa: E402
    NeuralNetConfiguration)
from deeplearning4j_torch.nn.conf.inputs import InputType  # noqa: E402
from deeplearning4j_torch.nn.conf.layers.core import (  # noqa: E402
    DenseLayer, OutputLayer)
from deeplearning4j_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_torch.nn.updater import Sgd  # noqa: E402
from deeplearning4j_torch.optimize.health import (  # noqa: E402
    DivergenceError, HealthPolicy, all_finite, resolve_health_policy,
    tree_select)
from deeplearning4j_torch.optimize.listeners import (  # noqa: E402
    HealthListener)
from deeplearning4j_torch.parallel.elastic import (  # noqa: E402
    CheckpointListener, CheckpointStore)

from tests.test_torch_fused_fit import (  # noqa: E402
    TOL, _graph, _max_param_diff)

pytestmark = pytest.mark.torch_port


def _batches(n, batch=16, nan_at=None, seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = (rs.randn(batch, 4) * scale).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, batch)]
        if i == nan_at:
            x[0, 0] = np.nan
        out.append(DataSet(x, y))
    return out


def _sgd_graph(seed=12345):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.05))
            .weight_init("xavier").activation("relu")
            .graph_builder().add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=16), "in")
            .add_layer("out", OutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"), "d1")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf).init(device="cpu")


def _params_flat(net):
    return net.params_flat()


def _opt_leaves(net):
    return [t.clone() for s in net.updater_state.values()
            for p in s.values() for t in p.values()]


# -------------------------------------------------------- device primitives
class TestDevicePrimitives:
    def test_all_finite(self):
        good = {"a": {"w": torch.ones(3), "b": torch.zeros(())}}
        assert bool(all_finite(torch.tensor(1.0), good))
        assert not bool(all_finite(torch.tensor(float("nan")), good))
        bad = {"a": {"w": torch.tensor([1.0, float("inf"), 0.0])}}
        assert not bool(all_finite(torch.tensor(1.0), bad))

    def test_tree_select(self):
        new = {"a": {"w": torch.ones(2)}}
        old = {"a": {"w": torch.zeros(2)}}
        assert torch.equal(tree_select(torch.tensor(True), new, old)["a"]["w"],
                           torch.ones(2))
        assert torch.equal(tree_select(torch.tensor(False), new,
                                       old)["a"]["w"], torch.zeros(2))

    def test_tree_select_structure_mismatch_passes_new(self):
        new = {"h": torch.ones(2)}
        assert tree_select(torch.tensor(False), new, {}) is new
        assert tree_select(torch.tensor(False), new, None) is new

    def test_resolve_health_policy(self):
        assert resolve_health_policy(None) is None
        assert resolve_health_policy(False) is None
        assert isinstance(resolve_health_policy(True), HealthPolicy)
        p = HealthPolicy()
        assert resolve_health_policy(p) is p
        with pytest.raises(TypeError):
            resolve_health_policy("on")


# ------------------------------------------------------------ guarded steps
class TestGuardedStep:
    def test_skipped_step_preserves_params_exactly(self):
        net = _graph()
        before = _params_flat(net)
        opt_before = _opt_leaves(net)
        net.fit(_batches(1, nan_at=0)[0],
                health_guard=HealthPolicy(skip_threshold=100))
        assert np.array_equal(before, _params_flat(net))
        for a, b in zip(opt_before, _opt_leaves(net)):
            assert torch.equal(a, b)
        assert net.iteration == 1

    def test_skipped_fused_slot_preserves_params_exactly(self):
        """A K = 2 block of two NaN batches: the whole block is the
        identity update."""
        net = _graph()
        before = _params_flat(net)
        pol = HealthPolicy(skip_threshold=100)
        bad = _batches(2, seed=3)
        for b in bad:
            b.features[0, 0] = np.nan
        net.fit(ListDataSetIterator(bad, batch_size=16), fused_steps=2,
                health_guard=pol)
        assert pol.total_skips == 2 and net.iteration == 2
        assert np.array_equal(before, _params_flat(net))

    def test_guard_off_poisons_params(self):
        net = _graph()
        net.fit(_batches(1, nan_at=0)[0], health_guard=None)
        assert not np.isfinite(_params_flat(net)).all()

    def test_guard_on_equals_guard_off_on_clean_data(self):
        it = ListDataSetIterator(_batches(8), batch_size=16)
        on, off = _graph(), _graph()
        on.fit(it, epochs=1, health_guard=HealthPolicy(skip_threshold=100))
        off.fit(it, epochs=1, health_guard=None)
        assert _max_param_diff(on, off) == 0.0

    @pytest.mark.parametrize("k", [1, 4])
    def test_nan_midstream_fused_matches_unfused(self, k):
        batches = _batches(8, nan_at=2, seed=5)
        ref, fus = _graph(), _graph()
        pol_ref = HealthPolicy(skip_threshold=100)
        pol_fus = HealthPolicy(skip_threshold=100)
        ref.fit(ListDataSetIterator(batches, batch_size=16), epochs=1,
                fused_steps=1, health_guard=pol_ref)
        fus.fit(ListDataSetIterator(batches, batch_size=16), epochs=1,
                fused_steps=k, health_guard=pol_fus)
        assert pol_ref.total_skips == pol_fus.total_skips == 1
        assert ref.iteration == fus.iteration == 8
        assert np.isfinite(_params_flat(fus)).all()
        assert _max_param_diff(ref, fus) == 0.0

    def test_nan_midstream_matches_jax(self):
        """The default fit (K = 2, guard on) over a stream with a NaN batch
        against JAX's default fit on the same weights: within TOL."""
        from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDS
        from deeplearning4j_tpu.datasets.iterators import (
            ListDataSetIterator as JaxIterator)
        from deeplearning4j_torch.utils.convert import (params_from_jax,
                                                        params_to_numpy)
        from tests.test_fused_fit import _graph as jax_graph

        batches = _batches(6, nan_at=3, seed=8)
        jnet, tnet = jax_graph(), _graph()
        params_from_jax(jax.device_get(jnet.params), tnet)
        jnet.fit(JaxIterator([JaxDS(b.features, b.labels) for b in batches],
                             batch_size=16))
        tnet.fit(ListDataSetIterator(batches, batch_size=16))
        ref = jax.device_get(jnet.params)
        got = params_to_numpy(tnet)
        for v in ref:
            for kk in ref[v]:
                np.testing.assert_allclose(got[v][kk], ref[v][kk], atol=TOL,
                                           rtol=0)

    def test_skipped_batch_equals_batch_never_seen(self):
        batches = _batches(6, nan_at=2, seed=9)
        clean = [b for i, b in enumerate(batches) if i != 2]
        guarded, never = _sgd_graph(), _sgd_graph()
        for b in batches:
            guarded.fit(b, health_guard=HealthPolicy(skip_threshold=100))
        for b in clean:
            never.fit(b, health_guard=HealthPolicy(skip_threshold=100))
        assert guarded.iteration == 6 and never.iteration == 5
        assert _max_param_diff(guarded, never) == 0.0

    def test_graph_guarded_skip(self):
        net = _graph()
        before = _params_flat(net)
        pol = HealthPolicy(skip_threshold=100)
        net.fit(ListDataSetIterator(_batches(4, nan_at=1), batch_size=16),
                epochs=1, health_guard=pol)
        assert pol.total_skips == 1
        assert np.isfinite(_params_flat(net)).all()
        assert not np.array_equal(before, _params_flat(net))

    def test_raw_nan_score_still_reported(self):
        net = _graph()
        net.fit(_batches(1, nan_at=0)[0],
                health_guard=HealthPolicy(skip_threshold=100))
        assert not np.isfinite(net.score())


# ----------------------------------------------------------- recovery ladder
class TestRecoveryLadder:
    def test_lr_backoff_first_rung(self):
        net = _graph()
        lr0 = net.conf.updater.learning_rate
        pol = HealthPolicy(skip_threshold=2, lr_backoff=0.5,
                           max_recoveries=5)
        events = []
        for b in _batches(3, seed=1):
            b.features[0, 0] = np.nan
            net.fit(b, health_guard=pol)
            events = [e["action"] for e in pol.events]
            if "lr_backoff" in events:
                break
        assert "lr_backoff" in events
        assert net.conf.updater.learning_rate == pytest.approx(lr0 * 0.5)
        assert len(net._step_cache) == 0
        net.fit(_batches(1, seed=2)[0], health_guard=pol)
        assert np.isfinite(_params_flat(net)).all()

    def test_spike_triggers_rollback(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=3)
        pol = HealthPolicy(store=store, save_frequency=4, warmup_steps=3,
                           spike_factor=5.0, skip_threshold=100,
                           lr_backoff=None)
        net = _graph()
        for b in _batches(8, seed=3):
            net.fit(b, health_guard=pol)
        assert store.latest() is not None
        spike = _batches(1, seed=4, scale=400.0)[0]
        net.fit(spike, health_guard=pol)
        actions = [e["action"] for e in pol.events]
        assert actions == ["rollback"]
        rolled = pol.events[0]
        assert net.iteration == rolled["restored_iteration"] < 9
        assert rolled["checkpoint_meta"]["healthy"] is True
        assert np.isfinite(_params_flat(net)).all()
        assert all(t.device == net.device for p in net.params.values()
                   for t in p.values())
        net.fit(_batches(1, seed=5)[0], health_guard=pol)  # trains on

    def test_ladder_exhaustion_raises_divergence_error(self):
        net = _graph()
        pol = HealthPolicy(skip_threshold=2, lr_backoff=0.5,
                           max_recoveries=2)
        with pytest.raises(DivergenceError, match="exhausted"):
            for b in _batches(12, seed=6):
                b.features[0, 0] = np.nan
                net.fit(b, health_guard=pol)
        assert pol.events[-1]["action"] == "raise"
        assert pol.recoveries == 3

    def test_no_rung_available_raises(self):
        net = _graph()
        pol = HealthPolicy(skip_threshold=2, lr_backoff=None)
        with pytest.raises(DivergenceError, match="no recovery rung"):
            for b in _batches(6, seed=7):
                b.features[0, 0] = np.nan
                net.fit(b, health_guard=pol)

    def test_lr_backoff_validation(self):
        with pytest.raises(ValueError):
            HealthPolicy(lr_backoff=1.5)
        with pytest.raises(ValueError):
            HealthPolicy(skip_threshold=0)

    @pytest.mark.parametrize("rollback", [False, True])
    def test_ladder_walk_equals_jax(self, rollback):
        """The same per-block (score, skip) stream into JAX's and the
        port's ``HealthPolicy``: the same events (actions, reasons,
        iterations, counts, EMA, learning rates), the same saves, in the
        same order, ending in the same ``DivergenceError``."""
        from deeplearning4j_tpu.nn import updater as jup
        from deeplearning4j_tpu.optimize import health as jh
        from deeplearning4j_torch.nn import updater as tup

        class Store:
            def __init__(self):
                self.saves = []

            def save(self, net, meta):
                self.saves.append((net.iteration, dict(meta)))

            def restore(self, device=None):
                if not self.saves:
                    return None
                it = self.saves[-1][0]
                ck = type("Ckpt", (), dict(params={}, updater_state={},
                                           state={}, iteration=it))
                return ck, {"healthy": True}

        class Net:
            def __init__(self, updater):
                self.conf = type("Conf", (), {"updater": updater})
                self.iteration = 0
                self.listeners = []
                self._step_cache = {"k": 1}

        rs = np.random.RandomState(11)
        blocks = []
        for i in range(40):
            k = 1 + i % 3
            s = rs.uniform(1.0, 2.0, k)
            sk = np.zeros(k)
            if 14 <= i < 20 or i >= 32:
                sk[:] = 1.0
                s[:] = np.nan
            if i == 25:
                s[0] = 100.0
            blocks.append((s, sk))
        runs = {}
        for name, mod, upd in (("jax", jh, jup.Sgd(learning_rate=0.1)),
                               ("port", None, tup.Sgd(learning_rate=0.1))):
            cls = mod.HealthPolicy if mod is not None else HealthPolicy
            err = mod.DivergenceError if mod is not None else DivergenceError
            store = Store() if rollback else None
            pol = cls(store=store, save_frequency=5, skip_threshold=4,
                      warmup_steps=3, spike_factor=5.0,
                      lr_backoff=0.5, max_recoveries=3)
            net = Net(upd)
            raised = None
            try:
                for s, sk in blocks:
                    it0 = net.iteration
                    net.iteration += len(s)
                    pol.observe(net, s, sk, it0)
            except err as e:
                raised = str(e)
            runs[name] = (pol.events, None if store is None
                          else store.saves, raised, upd.learning_rate,
                          net._step_cache)
        jev, jsaves, jraise, jlr, _ = runs["jax"]
        tev, tsaves, traise, tlr, tcache = runs["port"]
        assert [e["action"] for e in tev] == [e["action"] for e in jev]
        assert len(tev) >= 4 and tev[-1]["action"] == "raise"
        for a, b in zip(tev, jev):
            assert set(a) == set(b)
            for key in a:
                if isinstance(a[key], float):
                    assert a[key] == pytest.approx(b[key], rel=1e-12)
                else:
                    assert a[key] == b[key], key
        assert tsaves == jsaves and traise == jraise and tlr == jlr
        assert tcache == {}
        if rollback:
            assert "rollback" in [e["action"] for e in tev]


# ------------------------------------------------- healthy-gated checkpoints
class TestHealthyGatedCheckpoints:
    def test_unhealthy_window_not_saved(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=10)
        pol = HealthPolicy(store=store, save_frequency=4, skip_threshold=100)
        net = _graph()
        for b in _batches(4, seed=8):
            net.fit(b, health_guard=pol)
        n_clean = len(store.checkpoints())
        assert n_clean == 1
        for b in _batches(4, nan_at=1, seed=9):
            net.fit(b, health_guard=pol)
        assert len(store.checkpoints()) == n_clean
        for b in _batches(4, seed=10):
            net.fit(b, health_guard=pol)
        assert len(store.checkpoints()) == n_clean + 1

    def test_checkpoint_listener_health_gated(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=10)
        listener = CheckpointListener(store, frequency=1)
        net = _graph()
        net.set_listeners(listener)
        net.fit(_batches(1, nan_at=0)[0],
                health_guard=HealthPolicy(skip_threshold=100))
        assert listener.skipped_unhealthy == 1 and listener.saved == 0
        net.set_listeners()
        net.fit(_batches(1)[0], health_guard=None)
        net.set_listeners(listener)
        net.fit(_batches(1, seed=2)[0], health_guard=None)
        assert listener.saved == 1

    def test_store_restores_the_saved_net(self, tmp_path):
        """A checkpoint is the model zip: restore gives back the params,
        updater state and iteration it saved, on the requested device."""
        store = CheckpointStore(str(tmp_path), keep=2)
        net = _graph()
        net.fit(_batches(3, seed=12)[0], health_guard=None)
        store.save(net, {"note": 1})
        restored, meta = store.restore(device="cpu")
        assert meta == {"note": 1} and restored.iteration == net.iteration
        assert np.array_equal(restored.params_flat(), net.params_flat())
        for a, b in zip(_opt_leaves(restored), _opt_leaves(net)):
            assert torch.equal(a, b)
        assert CheckpointStore(str(tmp_path / "empty")).restore("cpu") is None


# ------------------------------------------------------------- observability
class TestHealthListener:
    def test_on_health_reports(self):
        net = _graph()
        hl = HealthListener(log_events=False)
        net.set_listeners(hl)
        pol = HealthPolicy(skip_threshold=100)
        net.fit(ListDataSetIterator(_batches(4, nan_at=1), batch_size=16),
                epochs=1, health_guard=pol)
        skips = [r for r in hl.reports if r["action"] == "skip"]
        assert len(skips) == 1
        assert skips[0]["total_skips"] == 1
        assert [e["action"] for e in pol.events] == \
            [r["action"] for r in hl.reports]

    def test_metrics_carry_jax_names(self):
        from deeplearning4j_torch.metrics import MetricsRegistry, render_text

        reg = MetricsRegistry()
        pol = HealthPolicy(skip_threshold=100, registry=reg)
        net = _graph()
        net.fit(ListDataSetIterator(_batches(2, nan_at=0), batch_size=16),
                fused_steps=1, health_guard=pol)
        text = render_text([({}, reg)])
        for name in ("health_events_total", "health_loss_ema",
                     "health_consecutive_skips", "health_total_skips",
                     "health_recoveries"):
            assert name in text
        assert 'health_events_total{action="skip"} 1' in text
