"""The port's datasets (``datasets/{curves,cifar,mnist,iterators,
streaming,dataset}.py``) against the JAX package's on the CPU:

- the curves set, CIFAR-10 and LFW (synthetic and read from files in the
  standard layouts), Iris and the sampling iterator give JAX's arrays bit
  for bit for the same arguments; counterparts of ``tests/test_coredata.
  py``'s curves, CIFAR/LFW and ``labels=None`` cases;
- counterparts of ``tests/test_iterators.py``: ``AsyncDataSetIterator``
  yields the base's batches, raises the producer's error and joins its
  thread (also when the consumer stops early); ``DevicePrefetchIterator``
  keeps ``depth`` batches placed ahead, passes masks and missing labels
  through, refuses ``sharding=`` naming ROADMAP A11c, and ``fit`` through
  it (and through both wrapped together) equals ``fit`` through the plain
  iterator bit for bit; ``MultipleEpochsIterator`` replays its base;
- counterparts of ``tests/test_streaming.py``: training from a producer
  thread, backpressure, end-of-stream rules, the bounded pass over an
  endless source and collation.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_torch.datasets import curves as tcurves
from deeplearning4j_torch.datasets import cifar as tcifar
from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.iterators import (
    AsyncDataSetIterator, DataSetIterator, DevicePrefetchIterator,
    ListDataSetIterator, MultipleEpochsIterator, SamplingDataSetIterator)
from deeplearning4j_torch.datasets.streaming import (
    ExampleCollator, QueueDataSetIterator, StreamingDataSetIterator)

pytestmark = pytest.mark.torch_port


def _same(got, ref):
    """Two DataSet streams hold equal arrays, batch for batch."""
    got, ref = list(got), list(ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for name in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
                assert x.dtype == np.asarray(y).dtype, name


# ------------------------------------------------------------- built-ins
class TestCurves:
    def test_shapes_labels_and_determinism(self):
        it = tcurves.CurvesDataSetIterator(batch_size=32, num_examples=96)
        batches = list(it)
        assert len(batches) == 3
        ds = batches[0]
        assert ds.features.shape == (32, 784)
        assert ds.features.dtype == np.float32
        np.testing.assert_array_equal(ds.features, ds.labels)
        assert 0.0 <= float(ds.features.min()) and \
            float(ds.features.max()) <= 1.0
        assert 0.01 < float((ds.features > 0.05).mean()) < 0.4
        again = list(tcurves.CurvesDataSetIterator(batch_size=32,
                                                   num_examples=96))
        np.testing.assert_array_equal(ds.features, again[0].features)

    @pytest.mark.parametrize("seed", [7, 21])
    def test_equals_jax_curves(self, seed):
        from deeplearning4j_tpu.datasets.curves import CurvesDataSetIterator

        _same(tcurves.CurvesDataSetIterator(batch_size=40, num_examples=100,
                                            seed=seed),
              CurvesDataSetIterator(batch_size=40, num_examples=100,
                                    seed=seed))

    def test_local_file_is_read(self, tmp_path):
        from deeplearning4j_tpu.datasets.curves import CurvesDataSetIterator

        feats = np.random.RandomState(0).rand(50, 784)
        np.savez(tmp_path / "curves.npz", features=feats)
        _same(tcurves.CurvesDataSetIterator(batch_size=16, num_examples=40,
                                            path=str(tmp_path)),
              CurvesDataSetIterator(batch_size=16, num_examples=40,
                                    path=str(tmp_path)))

    def test_autoencoder_pretraining_reduces_error(self):
        """The set's purpose: an AutoEncoder pretrained on it reconstructs
        better, then a dense reconstruction net fits it."""
        from deeplearning4j_torch.nn.conf.builders import (
            NeuralNetConfiguration)
        from deeplearning4j_torch.nn.conf.inputs import InputType
        from deeplearning4j_torch.nn.conf.layers import (AutoEncoder,
                                                         DenseLayer,
                                                         OutputLayer)
        from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_torch.nn.updater import Adam

        it = tcurves.CurvesDataSetIterator(batch_size=64, num_examples=256)
        conf = (NeuralNetConfiguration.builder().seed(5)
                .updater(Adam(learning_rate=1e-3))
                .list(AutoEncoder(n_out=64, corruption_level=0.2),
                      DenseLayer(n_out=64, activation="relu"),
                      OutputLayer(n_out=784, activation="sigmoid",
                                  loss="mse"))
                .set_input_type(InputType.feed_forward(784)).build())
        net = MultiLayerNetwork(conf).init(device="cpu")
        ae = net.layers[0]
        x = torch.from_numpy(next(iter(it)).features)

        def recon():
            with torch.no_grad():
                return float(ae.reconstruction_loss_per_example(
                    net.params["0"], x).mean())

        r0 = recon()
        net.pretrain(it, epochs=4)
        assert recon() < r0
        s0 = net.score(next(iter(it)))
        net.fit(it, epochs=4)
        assert np.isfinite(net.score()) and net.score(next(iter(it))) < s0


class TestCifarLfw:
    def test_cifar_synthetic_equals_jax_and_trains(self):
        from deeplearning4j_torch.nn.conf.builders import (
            NeuralNetConfiguration)
        from deeplearning4j_torch.nn.conf.inputs import InputType
        from deeplearning4j_torch.nn.conf.layers import (ConvolutionLayer,
                                                         DenseLayer,
                                                         OutputLayer,
                                                         SubsamplingLayer)
        from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_torch.nn.updater import Adam
        from deeplearning4j_tpu.datasets.cifar import CifarDataSetIterator

        it = tcifar.CifarDataSetIterator(batch_size=64, num_examples=256)
        assert it.synthetic
        _same(it, CifarDataSetIterator(batch_size=64, num_examples=256))
        _same(tcifar.CifarDataSetIterator(batch_size=64, num_examples=64,
                                          train=False),
              CifarDataSetIterator(batch_size=64, num_examples=64,
                                   train=False))
        ds0 = next(iter(it))
        assert ds0.features.shape == (64, 32, 32, 3)
        conf = (NeuralNetConfiguration.builder()
                .seed(1).updater(Adam(learning_rate=1e-3))
                .list(ConvolutionLayer(n_out=8, kernel_size=(5, 5),
                                       convolution_mode="same",
                                       activation="relu"),
                      SubsamplingLayer(kernel_size=(4, 4), stride=(4, 4)),
                      DenseLayer(n_out=32, activation="relu"),
                      OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
                .set_input_type(InputType.convolutional(32, 32, 3))
                .build())
        net = MultiLayerNetwork(conf).init(device="cpu")
        losses = []
        for _ in range(8):
            it.reset()
            ep = [float(net.do_step(ds.features, ds.labels)[0]) for ds in it]
            losses.append(float(np.mean(ep)))
        assert losses[-1] < losses[0] * 0.7, losses

    @pytest.mark.parametrize("train", [True, False])
    def test_cifar_binary_files_equal_jax(self, tmp_path, train):
        from deeplearning4j_tpu.datasets.cifar import CifarDataSetIterator

        rs = np.random.RandomState(3)
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            rows = rs.randint(0, 256, (6, 3073)).astype(np.uint8)
            rows[:, 0] %= 10
            rows.tofile(tmp_path / name)
        it = tcifar.CifarDataSetIterator(batch_size=8, train=train,
                                         num_examples=20,
                                         path=str(tmp_path))
        assert not it.synthetic
        _same(it, CifarDataSetIterator(batch_size=8, train=train,
                                       num_examples=20, path=str(tmp_path)))

    def test_lfw_synthetic_shapes_and_equal_jax(self):
        from deeplearning4j_tpu.datasets.cifar import LFWDataSetIterator

        it = tcifar.LFWDataSetIterator(batch_size=16, num_examples=64,
                                       image_size=32, num_people=5)
        ds = next(iter(it))
        assert ds.features.shape == (16, 32, 32, 3)
        assert ds.labels.shape == (16, 5)
        _same(it, LFWDataSetIterator(batch_size=16, num_examples=64,
                                     image_size=32, num_people=5))

    def test_lfw_directory_equals_jax(self, tmp_path):
        from PIL import Image

        from deeplearning4j_tpu.datasets.cifar import LFWDataSetIterator

        rs = np.random.RandomState(4)
        for person in ("ada", "bob", "cy"):
            (tmp_path / person).mkdir()
            for k in range(3):
                px = rs.randint(0, 256, (20, 24, 3)).astype(np.uint8)
                Image.fromarray(px).save(tmp_path / person / f"{k}.png")
        it = tcifar.LFWDataSetIterator(batch_size=4, num_examples=7,
                                       image_size=16, path=str(tmp_path))
        assert not it.synthetic
        _same(it, LFWDataSetIterator(batch_size=4, num_examples=7,
                                     image_size=16, path=str(tmp_path)))


def test_iris_equals_jax():
    from deeplearning4j_torch.datasets.mnist import IrisDataSetIterator
    from deeplearning4j_tpu.datasets.mnist import (
        IrisDataSetIterator as JIris)

    it = IrisDataSetIterator(batch_size=50)
    batches = list(it)
    assert [b.num_examples() for b in batches] == [50, 50, 50]
    assert batches[0].labels.shape == (50, 3)
    _same(it, JIris(batch_size=50))
    _same(IrisDataSetIterator(batch_size=32, num_examples=100, seed=3),
          JIris(batch_size=32, num_examples=100, seed=3))


def test_dataset_without_labels_supports_all_helpers():
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    ds = DataSet(x, None)
    ds.shuffle(seed=0)
    assert ds.labels is None
    tr, te = ds.split_test_and_train(6)
    assert tr.labels is None and te.num_examples() == 4
    batches = list(ds.batch_by(4))
    assert [b.num_examples() for b in batches] == [4, 4, 2]
    assert all(b.labels is None for b in batches)
    merged = DataSet.merge(batches)
    assert merged.labels is None and merged.num_examples() == 10
    on = DataSet.on_device(torch.from_numpy(x))
    assert torch.is_tensor(on.features) and on.labels is None


# -------------------------------------------------------------- iterators
def _data(n=20, batch=8):
    rs = np.random.RandomState(0)
    return ListDataSetIterator(
        DataSet(rs.randn(n, 4).astype(np.float32),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]),
        batch_size=batch)


class _Counting(DataSetIterator):
    def __init__(self, base):
        self.base = base
        self.produced = 0

    def reset(self):
        self.base.reset()

    def _iterate(self):
        for ds in self.base._iterate():
            self.produced += 1
            yield ds


class TestAsyncDataSetIterator:
    def test_same_batches_as_base(self):
        _same(AsyncDataSetIterator(_data(), queue_size=2), _data())

    def test_producer_exception_surfaces(self):
        class Boom(DataSetIterator):
            def _iterate(self):
                yield next(iter(_data()))
                raise RuntimeError("producer died")

        with pytest.raises(RuntimeError, match="producer died"):
            list(AsyncDataSetIterator(Boom()))

    def test_thread_joined_after_early_stop(self):
        before = threading.active_count()
        gen = iter(AsyncDataSetIterator(_data(n=400, batch=4), queue_size=1))
        next(gen)
        gen.close()
        assert threading.active_count() == before


class TestDevicePrefetchIterator:
    def test_values_equal_and_placed(self):
        pre = list(DevicePrefetchIterator(_data(), depth=2, device="cpu"))
        assert all(torch.is_tensor(d.features) and torch.is_tensor(d.labels)
                   for d in pre)
        _same(pre, _data())

    def test_transfers_run_ahead_of_consumption(self):
        counting = _Counting(_data(n=40, batch=8))
        it = iter(DevicePrefetchIterator(counting, depth=3, device="cpu"))
        next(it)
        assert counting.produced == 4

    def test_sharding_is_not_ported(self):
        """``sharding=`` (once refused naming A11c) places each batch as
        one piece per mesh device, as JAX's ``NamedSharding(mesh,
        P("data"))`` does; a non-placement and a bad depth raise."""
        from deeplearning4j_torch.parallel.mesh import (DataSharding, Mesh,
                                                        ShardedArray)

        sh = DataSharding(Mesh([torch.device("cpu")] * 4, ("data",)))
        pre = list(DevicePrefetchIterator(_data(n=16, batch=8), depth=2,
                                          sharding=sh))
        for ds in pre:
            assert isinstance(ds.features, ShardedArray)
            assert ds.features.sharding == sh
            assert [tuple(p.shape) for p in ds.features.pieces] == \
                [(2,) + tuple(ds.features.shape[1:])] * 4
        _same(pre, _data(n=16, batch=8))
        with pytest.raises(TypeError, match="DataSharding"):
            DevicePrefetchIterator(_data(), sharding="data", device="cpu")
        with pytest.raises(ValueError, match="depth"):
            DevicePrefetchIterator(_data(), depth=0, device="cpu")

    def test_masks_and_none_labels_pass_through(self):
        rs = np.random.RandomState(1)
        ds = DataSet(rs.randn(4, 3, 2).astype(np.float32),
                     rs.randn(4, 3, 2).astype(np.float32),
                     features_mask=np.ones((4, 3), np.float32))
        out = list(DevicePrefetchIterator([ds], depth=1, device="cpu"))[0]
        assert torch.is_tensor(out.features_mask)
        assert out.labels_mask is None
        none = list(DevicePrefetchIterator([DataSet(ds.features, None)],
                                           device="cpu"))[0]
        assert none.labels is None

    @pytest.mark.parametrize("wrap", ["prefetch", "async_prefetch"])
    def test_fit_through_it_is_bitwise_the_plain_iterator(self, wrap):
        """``fit`` at its defaults (the fused driver) through the prefetch
        iterator, alone or under ``AsyncDataSetIterator``, ends on the
        plain iterator's parameters bit for bit; training lowers the
        score."""
        from deeplearning4j_torch.nn.conf.builders import (
            NeuralNetConfiguration)
        from deeplearning4j_torch.nn.conf.inputs import InputType
        from deeplearning4j_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
        from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_torch.nn.updater import Adam

        def net():
            conf = (NeuralNetConfiguration.builder().seed(1)
                    .updater(Adam(learning_rate=0.01))
                    .list(DenseLayer(n_out=8, activation="relu"),
                          OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
                    .set_input_type(InputType.feed_forward(4)).build())
            return MultiLayerNetwork(conf).init(device="cpu")

        plain, pre = net(), net()
        s0 = plain.score(next(iter(_data())))
        plain.fit(_data(), epochs=5)
        it = DevicePrefetchIterator(_data(), depth=2, device="cpu")
        if wrap == "async_prefetch":
            it = AsyncDataSetIterator(it, queue_size=2)
        pre.fit(it, epochs=5)
        assert pre.iteration == plain.iteration == 15
        np.testing.assert_array_equal(pre.params_flat(), plain.params_flat())
        assert plain.score(next(iter(_data()))) < s0


def test_multiple_epochs_iterator_replays_base():
    base = _data(n=20, batch=8)
    got = list(MultipleEpochsIterator(base, 3))
    assert len(got) == 9
    _same(got, list(_data()) * 3)


def test_sampling_iterator_equals_jax():
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import (
        SamplingDataSetIterator as JSampling)

    rs = np.random.RandomState(2)
    x = rs.randn(30, 3).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 30)]
    t = SamplingDataSetIterator(DataSet(x, y), 8, 5, seed=4)
    j = JSampling(JDataSet(x, y), 8, 5, seed=4)
    for _ in range(2):            # each pass draws anew, as JAX's
        _same(t, j)


# -------------------------------------------------------------- streaming
def _net():
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    conf = (NeuralNetConfiguration.builder()
            .seed(3).updater(Adam(learning_rate=0.01))
            .list(DenseLayer(n_out=8, activation="relu"),
                  OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _batch(rs, n=16):
    labels = rs.randint(0, 2, n)
    return DataSet((rs.randn(n, 4) + labels[:, None]).astype(np.float32),
                   np.eye(2, dtype=np.float32)[labels])


class TestQueueIterator:
    def test_train_from_producer_thread(self):
        it = QueueDataSetIterator(maxsize=4)
        rs = np.random.RandomState(0)

        def produce():
            for _ in range(12):
                it.put(_batch(rs))
                time.sleep(0.002)
            it.end()

        t = threading.Thread(target=produce)
        t.start()
        net = _net()
        net.fit(it)
        t.join()
        assert net.iteration == 12

    def test_backpressure_blocks_producer(self):
        it = QueueDataSetIterator(maxsize=2)
        rs = np.random.RandomState(1)
        it.put(_batch(rs))
        it.put(_batch(rs))
        with pytest.raises(queue.Full):
            it.put(_batch(rs), timeout=0.1)

    def test_put_after_end_rejected(self):
        it = QueueDataSetIterator()
        it.end()
        with pytest.raises(RuntimeError, match="already ended"):
            it.put(_batch(np.random.RandomState(2)))

    def test_second_pass_after_end_terminates(self):
        it = QueueDataSetIterator()
        it.put(_batch(np.random.RandomState(5)))
        it.end()
        assert len(list(it)) == 1
        assert list(it) == []

    def test_end_with_full_buffer_does_not_block(self):
        it = QueueDataSetIterator(maxsize=1)
        it.put(_batch(np.random.RandomState(6)))
        t0 = time.time()
        it.end()
        assert time.time() - t0 < 1.0
        assert len(list(it)) == 1


def test_bounded_pass_over_endless_source():
    rs = np.random.RandomState(3)

    def endless():
        while True:
            yield _batch(rs)

    it = StreamingDataSetIterator(endless(), max_batches=5)
    net = _net()
    net.fit(it)
    assert net.iteration == 5
    net.fit(it)                    # the next pass continues the stream
    assert net.iteration == 10


class TestCollator:
    def test_collates_records_into_batches_as_jax(self):
        from deeplearning4j_tpu.datasets.streaming import (
            ExampleCollator as JCollator)

        sink = QueueDataSetIterator()
        col = ExampleCollator(batch_size=4, sink=sink)
        jcol = JCollator(batch_size=4)
        rs = np.random.RandomState(4)
        ref = []
        for i in range(10):
            f = rs.randn(3).astype(np.float32)
            lab = np.eye(2, dtype=np.float32)[i % 2]
            col.add(f, lab)
            out = jcol.add(f, lab)
            if out is not None:
                ref.append(out)
        col.flush()
        ref.append(jcol.flush())
        sink.end()
        got = list(sink)
        assert [ds.features.shape[0] for ds in got] == [4, 4, 2]
        _same(got, ref)

    def test_thread_safe_collation(self):
        col = ExampleCollator(batch_size=8)
        out = []
        lock = threading.Lock()

        def worker(seed):
            rs = np.random.RandomState(seed)
            for _ in range(40):
                ds = col.add(rs.randn(3).astype(np.float32),
                             np.eye(2, dtype=np.float32)[0])
                if ds is not None:
                    with lock:
                        out.append(ds)

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(ds.num_examples() for ds in out) == 160
        assert all(ds.num_examples() == 8 for ds in out)
