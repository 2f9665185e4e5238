"""The port's fused K-step fit driver (``optimize/fused_fit.py``), on the CPU:
the cases of ``tests/test_fused_fit.py`` on the graph net (Dense relu ->
OutputLayer softmax/mcxent, Adam 0.02), and the port's ``fit`` at its
defaults held to JAX's ``fit`` at its defaults.

A fused block runs the very operations of K unfused steps, so where the
batches have one shape the fused run equals ``fused_steps=1`` BIT FOR BIT
(scores, listener iterations, final params); JAX's tests bound the same
comparison by ``TOL`` (1e-5). A padded partial batch (a masked mean over
the bucket's rows against the unfused plain mean over its own) is held to
``TOL``, as in JAX. Against JAX: ``fit`` at the defaults (K = 2 on the CPU,
guard on) within 1e-5, scores and params.
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
from deeplearning4j_torch.nn.updater import Adam  # noqa: E402
from deeplearning4j_torch.optimize.fused_fit import (  # noqa: E402
    DEFAULT_FUSED_STEPS, DEFAULT_FUSED_STEPS_CPU, FusedFitDriver,
    device_put_ahead, resolve_fused_steps)
from deeplearning4j_torch.optimize.listeners import (  # noqa: E402
    CollectScoresIterationListener, TrainingListener)
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    params_from_jax, params_to_numpy)

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def _graph(seed=12345):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(0.02))
            .weight_init("xavier").activation("relu")
            .graph_builder().add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=16), "in")
            .add_layer("out", OutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"), "d1")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf).init(device="cpu")


def _iris_like(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return DataSet(x, y)


def _max_param_diff(a, b):
    return max(float((a.params[v][k] - b.params[v][k]).abs().max())
               for v in a.params for k in a.params[v])


# ------------------------------------------------------------- equivalence
class TestFusedEquivalence:
    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_fused_equals_unfused_bitwise(self, k):
        """Same seeds: K-fused training equals the per-minibatch path bit
        for bit, in the per-iteration scores, the listener iterations and
        the final params."""
        it = ListDataSetIterator(_iris_like(128), batch_size=32)
        ref, fus = _graph(), _graph()
        ref_scores = CollectScoresIterationListener()
        fus_scores = CollectScoresIterationListener()
        ref.set_listeners(ref_scores)
        fus.set_listeners(fus_scores)
        ref.fit(it, epochs=2, fused_steps=1)
        fus.fit(it, epochs=2, fused_steps=k)
        assert fus.iteration == ref.iteration == 8
        assert _max_param_diff(ref, fus) == 0.0
        assert [i for i, _ in ref_scores.scores] == \
            [i for i, _ in fus_scores.scores] == list(range(1, 9))
        assert [float(s) for _, s in ref_scores.scores] == \
            [float(s) for _, s in fus_scores.scores]

    def test_fused_matches_unfused_graph(self):
        it = ListDataSetIterator(_iris_like(128), batch_size=32)
        ref, fus = _graph(), _graph()
        ref.fit(it, epochs=2, fused_steps=1)
        fus.fit(it, epochs=2, fused_steps=4)
        assert fus.iteration == ref.iteration == 8
        assert _max_param_diff(ref, fus) == 0.0
        assert ref.score() == fus.score()

    def test_tail_group_runs_unfused(self):
        """Six batches at K = 4: one fused block, then the two-batch tail
        through the per-minibatch step; the result is the unfused one."""
        it = ListDataSetIterator(_iris_like(192), batch_size=32)
        ref, fus = _graph(), _graph()
        ref.fit(it, epochs=1, fused_steps=1)
        fus.fit(it, epochs=1, fused_steps=4)
        assert fus.iteration == ref.iteration == 6
        assert _max_param_diff(ref, fus) == 0.0
        fused_keys = [kk for kk in fus._step_cache if kk[0] == "fused"]
        unfused_keys = [kk for kk in fus._step_cache if kk[0] != "fused"]
        assert len(fused_keys) == 1 and len(unfused_keys) == 1

    def test_fit_defaults_match_jax(self):
        """``fit`` at the defaults (K = 2 on the CPU, the guard on) against
        the JAX package's ``fit`` at its defaults, from the same weights:
        per-iteration scores and final params within 1e-5."""
        from deeplearning4j_tpu.datasets.iterators import (
            ListDataSetIterator as JaxIterator)
        from deeplearning4j_tpu.optimize.listeners import (
            CollectScoresIterationListener as JaxCollect)
        from tests.test_fused_fit import _graph as jax_graph

        from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDS

        data = _iris_like(160, seed=3)
        jnet, tnet = jax_graph(), _graph()
        params_from_jax(jax.device_get(jnet.params), tnet)
        jc, tc = JaxCollect(), CollectScoresIterationListener()
        jnet.set_listeners(jc)
        tnet.set_listeners(tc)
        jnet.fit(JaxIterator(JaxDS(data.features, data.labels),
                             batch_size=32), epochs=2)
        tnet.fit(ListDataSetIterator(data, batch_size=32), epochs=2)
        assert tnet.iteration == jnet.iteration == 10
        np.testing.assert_allclose([float(s) for _, s in tc.scores],
                                   [float(s) for _, s in jc.scores],
                                   atol=1e-5, rtol=0)
        ref = jax.device_get(jnet.params)
        got = params_to_numpy(tnet)
        for v in ref:
            for k in ref[v]:
                np.testing.assert_allclose(got[v][k], ref[v][k], atol=1e-5,
                                           rtol=0, err_msg=f"{v}.{k}")


# --------------------------------------------------- bucketing / recompiles
class TestShapeBucketing:
    def test_trailing_partial_batch_correctness(self):
        """118 rows at batch 32: the 22-row batch is padded to the bucket
        with zeroed label-mask rows, and training matches the unfused path
        (which sees the raw 22-row batch) within TOL."""
        it = ListDataSetIterator(_iris_like(118), batch_size=32)
        ref, fus = _graph(), _graph()
        ref.fit(it, epochs=3, fused_steps=1)
        fus.fit(it, epochs=3, fused_steps=4)
        assert fus.iteration == ref.iteration == 12
        assert _max_param_diff(ref, fus) <= TOL

    def test_ragged_epoch_single_step_function(self):
        """A ragged epoch runs through ONE cached fused step: the padded
        batch shares the full block's key."""
        it = ListDataSetIterator(_iris_like(118), batch_size=32)
        net = _graph()
        net.fit(it, epochs=3, fused_steps=4)
        assert len(net._step_cache) == 1
        (key,) = net._step_cache
        assert key[0] == "fused" and key[1] == 4

    def test_masked_stream_buckets(self):
        """Streams that already carry a labels_mask bucket too (the pad
        rows extend the mask with zeros)."""
        rs = np.random.RandomState(3)
        n = 80  # batch 32 -> 32, 32, 16
        x = rs.randn(n, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
        lm = np.ones(n, np.float32)
        lm[::7] = 0.0
        ds = DataSet(x, y, None, lm)
        ref, fus = _graph(), _graph()
        ref.fit(ListDataSetIterator(ds, batch_size=32), epochs=3,
                fused_steps=1)
        fus.fit(ListDataSetIterator(ds, batch_size=32), epochs=3,
                fused_steps=3)
        assert fus.iteration == ref.iteration == 9
        assert _max_param_diff(ref, fus) <= TOL
        assert len([k for k in fus._step_cache if k[0] == "fused"]) == 1

    def test_features_mask_without_labels_mask_runs_unfused(self):
        """A features-mask stream with no labels mask: its short batch is
        not padded (a made-up label mask would shadow the features mask)
        and takes the per-minibatch path, bit for bit the unfused run."""
        rs = np.random.RandomState(4)
        n = 80
        x = rs.randn(n, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
        fm = np.ones(n, np.float32)
        ds = DataSet(x, y, fm, None)
        ref, fus = _graph(), _graph()
        ref.fit(ListDataSetIterator(ds, batch_size=32), fused_steps=1)
        fus.fit(ListDataSetIterator(ds, batch_size=32), fused_steps=2)
        assert fus.iteration == ref.iteration == 3
        assert _max_param_diff(ref, fus) == 0.0


# ------------------------------------------------------- score_value contract
class TestScoreValueContract:
    def test_score_value_stays_device_side(self):
        """With no listeners the last score stays a device tensor (no host
        sync); ``score()`` coerces it to a float."""
        net = _graph()
        assert isinstance(net.score(), float) and np.isnan(net.score())
        net.fit(ListDataSetIterator(_iris_like(64), batch_size=32),
                epochs=1, fused_steps=2)
        assert torch.is_tensor(net.score_value)
        s = net.score()
        assert isinstance(s, float) and np.isfinite(s)

    def test_score_no_arg_graph(self):
        net = _graph()
        net.fit(ListDataSetIterator(_iris_like(64), batch_size=32),
                epochs=1, fused_steps=2, health_guard=None)
        s = net.score()
        assert isinstance(s, float) and np.isfinite(s)

    def test_listener_path_scores_are_host_values(self):
        """With listeners the block's stacked losses come back in ONE
        fetch; ``iteration_done`` then sees host scores."""
        net = _graph()
        seen = []

        class Probe(TrainingListener):
            def iteration_done(self, model, iteration):
                seen.append((iteration, model.score_value))

        net.set_listeners(Probe())
        net.fit(ListDataSetIterator(_iris_like(128), batch_size=32),
                epochs=1, fused_steps=4)
        assert [i for i, _ in seen] == [1, 2, 3, 4]
        assert all(isinstance(s, np.floating) for _, s in seen)


# ----------------------------------------------------------- block listeners
class TestBlockListeners:
    def test_on_block_done_fires_once_per_block(self):
        net = _graph()
        blocks, iters, epochs = [], [], []

        class Probe(TrainingListener):
            def on_block_done(self, model, iterations, scores):
                blocks.append((list(iterations), np.asarray(scores)))

            def iteration_done(self, model, iteration):
                iters.append(iteration)

            def on_epoch_start(self, model):
                epochs.append(("start", model.epoch))

            def on_epoch_end(self, model):
                epochs.append(("end", model.epoch))

        net.set_listeners(Probe())
        net.fit(ListDataSetIterator(_iris_like(256), batch_size=32),
                epochs=1, fused_steps=4)  # 8 batches -> 2 full blocks
        assert len(blocks) == 2
        assert blocks[0][0] == [1, 2, 3, 4] and blocks[1][0] == [5, 6, 7, 8]
        assert all(s.shape == (4,) for _, s in blocks)
        assert iters == list(range(1, 9))
        assert epochs == [("start", 0), ("end", 0)] and net.epoch == 1


# ------------------------------------------------------------- driver bits
class TestDriverPlumbing:
    def test_fused_steps_validation(self):
        net = _graph()
        with pytest.raises(ValueError):
            net.fit(_iris_like(32), fused_steps=0)
        with pytest.raises(ValueError):
            FusedFitDriver(net, 0)

    def test_default_fused_steps_by_device(self):
        """K keys on the net's device: 2 on the CPU, 4 on CUDA."""
        net = _graph()
        assert resolve_fused_steps(net, None) == DEFAULT_FUSED_STEPS_CPU == 2
        net.device = torch.device("cuda", 0)
        assert resolve_fused_steps(net, None) == DEFAULT_FUSED_STEPS == 4
        assert resolve_fused_steps(net, 3) == 3

    def test_device_put_ahead_order_and_depth(self):
        placed = []
        out = list(device_put_ahead(range(7), 3,
                                    lambda v: placed.append(v) or v))
        assert out == list(range(7)) and placed == out
        with pytest.raises(ValueError):
            list(device_put_ahead(range(3), 0, lambda v: v))

    def test_cpu_block_placement_wraps_without_a_copy(self):
        """On the CPU a block's numpy stacks are wrapped, not copied."""
        net = _graph()
        drv = FusedFitDriver(net, 2)
        x = np.ones((2, 3, 4), np.float32)
        tag, (xs, ys, ims, lms) = drv._place(("block", (x, x, None, None)))
        assert tag == "block" and ims is None and lms is None
        assert xs.data_ptr() == x.ctypes.data

    def test_repeated_single_dataset_fuses_the_epochs(self):
        """``fit(ds, epochs=5)`` at K = 2 runs two blocks and a tail, bit for
        bit five unfused steps."""
        ds = _iris_like(32, seed=6)
        ref, fus = _graph(), _graph()
        ref.fit(ds, epochs=5, fused_steps=1)
        fus.fit(ds, epochs=5)
        assert ref.iteration == fus.iteration == 5
        assert _max_param_diff(ref, fus) == 0.0
        assert sorted(k[0] for k in fus._step_cache) == ["fused", "step"]
