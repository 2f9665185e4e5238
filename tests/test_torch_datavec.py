"""The port's ``datavec/`` (record readers and bridge iterators) against
the JAX package's on the CPU, over the same files made from a numpy seed:

- ``CSVRecordReader`` gives JAX's records from a numeric file (both through
  the native parser), from one with string fields (both through the
  ``csv`` module) and with ``skip_lines`` and another ``delimiter``;
- ``RecordReaderDataSetIterator`` gives JAX's batches bit for bit (one-hot
  labels, the trailing partial batch, ``label_index_to`` regression);
- ``CSVSequenceRecordReader`` over a directory and
  ``SequenceRecordReaderDataSetIterator`` give JAX's padded features,
  masks and masked one-hot labels;
- ``RecordReaderMultiDataSetIterator`` gives JAX's MultiDataSets and drops
  the partial last batch, as JAX's does;
- ``ImageRecordReader`` over PNGs written by PIL gives JAX's arrays, and
  without PIL it raises an ``ImportError`` naming PIL;
- ``fit`` from a record-reader iterator equals ``fit`` from the same
  batches held in memory, bit for bit.
"""

import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import datavec as jdv
from deeplearning4j_torch import datavec as tdv

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _same_batches(got, ref):
    """Two streams of DataSets (or MultiDataSets) hold equal arrays of
    equal dtypes, batch for batch."""
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        if hasattr(b, "features_mask"):
            names = ("features", "labels", "features_mask", "labels_mask")
            pairs = [(getattr(a, n), getattr(b, n), n) for n in names]
        else:
            pairs = [(x, y, f"features[{i}]")
                     for i, (x, y) in enumerate(zip(a.features, b.features))]
            pairs += [(x, y, f"labels[{i}]")
                      for i, (x, y) in enumerate(zip(a.labels, b.labels))]
            assert len(a.features) == len(b.features)
            assert len(a.labels) == len(b.labels)
        for x, y, name in pairs:
            assert (x is None) == (y is None), name
            if x is not None:
                x, y = _host(x), np.asarray(y)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)


def _numeric_csv(path, rows=37, cols=6, classes=4, seed=0, delimiter=",",
                 header=()):
    """A label column first, then float features (as MNIST's CSV lays
    them out), written from a numpy seed."""
    rs = np.random.RandomState(seed)
    lab = rs.randint(0, classes, rows)
    x = np.round(rs.randn(rows, cols - 1), 6)
    with open(path, "w") as f:
        for h in header:
            f.write(h + "\n")
        for i in range(rows):
            f.write(delimiter.join([str(lab[i])]
                                   + [repr(float(v)) for v in x[i]]) + "\n")
    return str(path)


class TestCSV:
    def test_numeric_file_takes_native_parser_in_both(self, tmp_path):
        p = _numeric_csv(tmp_path / "num.csv")
        a, b = tdv.CSVRecordReader(p), jdv.CSVRecordReader(p)
        arr = a.read_numeric()
        assert arr is not None and b.read_numeric() is not None
        np.testing.assert_array_equal(arr, b.read_numeric())
        assert list(a) == list(b)
        _same_batches(tdv.RecordReaderDataSetIterator(a, 8, label_index=0,
                                                      num_classes=4),
                      jdv.RecordReaderDataSetIterator(b, 8, label_index=0,
                                                      num_classes=4))

    def test_string_fields_fall_back_to_csv_module(self, tmp_path):
        p = tmp_path / "str.csv"
        rs = np.random.RandomState(1)
        with open(p, "w") as f:
            for i in range(11):
                f.write(f'"{rs.rand():.5f}",{rs.randint(0, 3)},'
                        f'name{i},{rs.rand():.4f}\n')
        a, b = tdv.CSVRecordReader(str(p)), jdv.CSVRecordReader(str(p))
        assert a.read_numeric() is None and b.read_numeric() is None
        recs = list(a)
        assert recs == list(b) and recs[0][2] == "name0"
        # the string column dropped by taking only numeric columns through
        # a collection reader: labels from column 1
        num = [[r[0], r[1], r[3]] for r in recs]
        _same_batches(
            tdv.RecordReaderDataSetIterator(
                tdv.CollectionRecordReader(num), 4, label_index=1),
            jdv.RecordReaderDataSetIterator(
                jdv.CollectionRecordReader(num), 4, label_index=1))

    @pytest.mark.parametrize("delimiter,skip", [(";", 2), ("\t", 1)])
    def test_skip_lines_and_delimiter(self, tmp_path, delimiter, skip):
        p = _numeric_csv(tmp_path / "d.csv", rows=13, seed=2,
                         delimiter=delimiter,
                         header=[f"header{i}" for i in range(skip)])
        a = tdv.CSVRecordReader(p, skip_lines=skip, delimiter=delimiter)
        b = jdv.CSVRecordReader(p, skip_lines=skip, delimiter=delimiter)
        recs = list(a)
        assert len(recs) == 13 and recs == list(b)
        _same_batches(tdv.RecordReaderDataSetIterator(a, 5, label_index=0),
                      jdv.RecordReaderDataSetIterator(b, 5, label_index=0))

    def test_label_index_to_regression(self, tmp_path):
        p = _numeric_csv(tmp_path / "r.csv", rows=9, cols=7, seed=3)
        kw = dict(label_index=2, label_index_to=4, regression=True)
        _same_batches(
            tdv.RecordReaderDataSetIterator(tdv.CSVRecordReader(p), 4, **kw),
            jdv.RecordReaderDataSetIterator(jdv.CSVRecordReader(p), 4, **kw))
        first = next(iter(tdv.RecordReaderDataSetIterator(
            tdv.CSVRecordReader(p), 4, **kw)))
        assert first.features.shape == (4, 4) and first.labels.shape == (4, 3)


class TestSequences:
    def test_sequence_directory_padded_and_masked(self, tmp_path):
        rs = np.random.RandomState(4)
        d = tmp_path / "seqs"
        d.mkdir()
        for i in range(7):
            T = rs.randint(2, 9)
            with open(d / f"{i:03d}.csv", "w") as f:
                for _ in range(T):
                    f.write(f"{rs.randn():.6f},{rs.randn():.6f},"
                            f"{rs.randint(0, 3)}\n")
        a, b = tdv.CSVSequenceRecordReader(str(d)), \
            jdv.CSVSequenceRecordReader(str(d))
        assert list(a) == list(b)
        got = list(tdv.SequenceRecordReaderDataSetIterator(a, 3,
                                                           num_classes=3))
        _same_batches(got, jdv.SequenceRecordReaderDataSetIterator(
            b, 3, num_classes=3))
        assert [g.features.shape[0] for g in got] == [3, 3, 1]
        m = got[0].features_mask
        assert m.shape == got[0].features.shape[:2] and (m[:, 0] == 1).all()
        assert (got[0].labels.sum(-1) == m).all()

    def test_sequence_regression(self, tmp_path):
        seqs = [[[0.5, 1.0], [1.5, 2.0], [2.5, 3.0]], [[3.5, 4.0]]]
        _same_batches(
            tdv.SequenceRecordReaderDataSetIterator(
                tdv.CollectionSequenceRecordReader(seqs), 2, regression=True),
            jdv.SequenceRecordReaderDataSetIterator(
                jdv.CollectionSequenceRecordReader(seqs), 2,
                regression=True))


def test_multi_dataset_iterator_drops_partial_batch(tmp_path):
    p1 = _numeric_csv(tmp_path / "a.csv", rows=10, cols=5, seed=5)
    p2 = _numeric_csv(tmp_path / "b.csv", rows=10, cols=3, seed=6)

    def build(dv):
        return (dv.RecordReaderMultiDataSetIterator(4)
                .add_reader("a", dv.CSVRecordReader(p1))
                .add_reader("b", dv.CSVRecordReader(p2))
                .add_input("a", 1, 4).add_input("b", 1, 2)
                .add_output_one_hot("a", 0, 4).add_output("b", 0, 0))

    got = list(build(tdv))
    _same_batches(got, list(build(jdv)))
    # 10 rows in batches of 4: the 2-row tail is dropped, as in JAX
    assert len(got) == 2
    assert [f.shape for f in got[0].features] == [(4, 4), (4, 2)]
    assert [y.shape for y in got[0].labels] == [(4, 4), (4, 1)]


class TestImages:
    def _tree(self, tmp_path):
        from PIL import Image

        rs = np.random.RandomState(7)
        root = tmp_path / "people"
        for person in ("ann", "bob", "cy"):
            (root / person).mkdir(parents=True)
            for j in range(2):
                px = rs.randint(0, 256, (10, 12, 3)).astype(np.uint8)
                Image.fromarray(px).save(root / person / f"{j}.png")
        return str(root)

    @pytest.mark.parametrize("channels", [3, 1])
    def test_image_reader_matches_jax(self, tmp_path, channels):
        root = self._tree(tmp_path)
        a = tdv.ImageRecordReader(8, 6, channels, root=root)
        b = jdv.ImageRecordReader(8, 6, channels, root=root)
        assert a.labels == b.labels == ["ann", "bob", "cy"]
        ra, rb = list(a), list(b)
        assert len(ra) == len(rb) == 6
        for (x, la), (y, lb) in zip(ra, rb):
            assert la == lb and x.shape == (8, 6, channels)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        _same_batches(
            tdv.RecordReaderDataSetIterator(a, 4, num_classes=3),
            jdv.RecordReaderDataSetIterator(b, 4, num_classes=3))

    def test_without_pil_raises_naming_it(self, tmp_path, monkeypatch):
        root = self._tree(tmp_path)
        rr = tdv.ImageRecordReader(8, 6, 3, root=root)
        monkeypatch.setitem(sys.modules, "PIL", None)
        with pytest.raises(ImportError, match="PIL"):
            list(rr)


def test_fit_from_reader_equals_fit_from_memory(tmp_path):
    """The reader's host batches, moved to the net's device by ``fit``,
    train bit for bit as the same arrays handed to ``fit`` directly."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    p = _numeric_csv(tmp_path / "fit.csv", rows=40, cols=9, classes=3,
                     seed=8)

    def net():
        conf = (NeuralNetConfiguration.builder().seed(3)
                .updater(Adam(learning_rate=1e-2))
                .list(DenseLayer(n_out=16, activation="relu"),
                      OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
                .set_input_type(InputType.feed_forward(8)).build())
        return MultiLayerNetwork(conf).init(device="cpu")

    it = tdv.RecordReaderDataSetIterator(tdv.CSVRecordReader(p), 8,
                                         label_index=0, num_classes=3)
    mem = [DataSet(d.features.copy(), d.labels.copy()) for d in it]
    a, b = net(), net()
    a.fit(it)
    b.fit(mem)
    assert a.iteration == b.iteration == 5
    for v in a.params:
        for k in a.params[v]:
            assert torch.equal(a.params[v][k], b.params[v][k]), (v, k)
