"""Record-reader -> DataSet bridge iterators (port of
``deeplearning4j_tpu/datavec/iterators.py``).

Reference: deeplearning4j-core datasets/datavec/
RecordReaderDataSetIterator.java (label column -> one-hot or regression
target), SequenceRecordReaderDataSetIterator.java (per-timestep labels,
ALIGN_END masking for variable length), RecordReaderMultiDataSetIterator
(named-reader column selections -> MultiDataSet).

Every batch is a host (numpy) ``DataSet``, built as the JAX package builds
it; ``fit`` copies it to the net's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_torch.datasets.dataset import DataSet, MultiDataSet


class RecordReaderDataSetIterator:
    """records -> DataSet batches (reference:
    RecordReaderDataSetIterator.java — labelIndex/numPossibleLabels for
    classification, regression flag for raw targets)."""

    def __init__(self, reader, batch_size: int, label_index: int = -1,
                 num_classes: Optional[int] = None, regression: bool = False,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to

    def reset(self):
        pass

    def __iter__(self):
        feats, labs = [], []
        for rec in self.reader:
            f, l = self._split(rec)
            feats.append(f)
            labs.append(l)
            if len(feats) == self.batch_size:
                yield self._make(feats, labs)
                feats, labs = [], []
        if feats:
            yield self._make(feats, labs)

    def _split(self, rec):
        if isinstance(rec[0], np.ndarray):  # image record: [array, label]
            return rec[0], rec[1]
        li = self.label_index if self.label_index >= 0 else len(rec) - 1
        if self.label_index_to is not None:  # multi-column regression target
            lab = [float(v) for v in rec[li:self.label_index_to + 1]]
            feat = [float(v) for i, v in enumerate(rec)
                    if i < li or i > self.label_index_to]
        else:
            lab = rec[li]
            feat = [float(v) for i, v in enumerate(rec) if i != li]
        return feat, lab

    def _make(self, feats, labs):
        x = np.asarray(feats, np.float32)
        if self.regression:
            y = np.asarray(labs, np.float32)
            if y.ndim == 1:
                y = y[:, None]
        else:
            n = self.num_classes or int(max(float(l) for l in labs)) + 1
            y = np.eye(n, dtype=np.float32)[
                np.asarray([int(float(l)) for l in labs])]
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator:
    """sequence records -> padded+masked rnn DataSets (reference:
    SequenceRecordReaderDataSetIterator.java, AlignmentMode.ALIGN_END
    semantics collapsed to: pad at the end to the batch's longest
    sequence, the mask marking valid steps)."""

    def __init__(self, reader, batch_size: int, label_index: int = -1,
                 num_classes: Optional[int] = None, regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def reset(self):
        pass

    def __iter__(self):
        buf = []
        for seq in self.reader:
            buf.append(seq)
            if len(buf) == self.batch_size:
                yield self._make(buf)
                buf = []
        if buf:
            yield self._make(buf)

    def _make(self, seqs):
        B = len(seqs)
        T = max(len(s) for s in seqs)
        li = self.label_index if self.label_index >= 0 \
            else len(seqs[0][0]) - 1
        F = len(seqs[0][0]) - 1
        x = np.zeros((B, T, F), np.float32)
        mask = np.zeros((B, T), np.float32)
        raw_labels = np.zeros((B, T), np.float32)
        for b, s in enumerate(seqs):
            for t, rec in enumerate(s):
                x[b, t] = [float(v) for i, v in enumerate(rec) if i != li]
                raw_labels[b, t] = float(rec[li])
                mask[b, t] = 1.0
        if self.regression:
            y = raw_labels[..., None]
        else:
            n = self.num_classes or int(raw_labels.max()) + 1
            y = np.eye(n, dtype=np.float32)[raw_labels.astype(int)]
            y *= mask[..., None]
        return DataSet(x, y, features_mask=mask, labels_mask=mask)


class RecordReaderMultiDataSetIterator:
    """Named readers + input/output column selections -> MultiDataSet
    (reference: RecordReaderMultiDataSetIterator.Builder addInput/
    addOutputOneHot). A partial last batch is dropped, as the JAX
    package's iterator drops it (its ``StopIteration`` ends the pass)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._readers: dict = {}
        self._inputs: list = []   # (reader_name, col_from, col_to)
        self._outputs: list = []  # (reader_name, col, num_classes|None)

    def add_reader(self, name: str, reader):
        self._readers[name] = reader
        return self

    def add_input(self, reader_name: str, col_from: int, col_to: int):
        self._inputs.append((reader_name, col_from, col_to))
        return self

    def add_output_one_hot(self, reader_name: str, col: int,
                           num_classes: int):
        self._outputs.append((reader_name, col, num_classes))
        return self

    def add_output(self, reader_name: str, col_from: int, col_to: int):
        self._outputs.append((reader_name, (col_from, col_to), None))
        return self

    def reset(self):
        pass

    def __iter__(self):
        iters = {k: iter(r) for k, r in self._readers.items()}
        while True:
            try:
                rows = [{k: next(it) for k, it in iters.items()}
                        for _ in range(self.batch_size)]
            except StopIteration:
                return
            feats = []
            for name, c0, c1 in self._inputs:
                feats.append(np.asarray(
                    [[float(v) for v in r[name][c0:c1 + 1]] for r in rows],
                    np.float32))
            labs = []
            for name, col, n in self._outputs:
                if n is not None:
                    idx = [int(float(r[name][col])) for r in rows]
                    labs.append(np.eye(n, dtype=np.float32)[idx])
                else:
                    c0, c1 = col
                    labs.append(np.asarray(
                        [[float(v) for v in r[name][c0:c1 + 1]]
                         for r in rows], np.float32))
            yield MultiDataSet(feats, labs)
