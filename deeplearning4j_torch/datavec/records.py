"""Record readers (port of ``deeplearning4j_tpu/datavec/records.py``;
reference: DataVec's RecordReader implementations — CSVRecordReader,
CSVSequenceRecordReader, ImageRecordReader; the SPI the bridge iterators
consume).

A record is a list of values (floats/strings); a sequence record is a list
of records. Readers are restartable iterables and run on the host: what
they read reaches the card through ``fit``.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Optional


class RecordReader:
    def __iter__(self):
        self.reset()
        return self._gen()

    def _gen(self):
        raise NotImplementedError

    def reset(self) -> None:
        pass


class SequenceRecordReader(RecordReader):
    pass


class CollectionRecordReader(RecordReader):
    """In-memory records (reference: CollectionRecordReader)."""

    def __init__(self, records: Iterable[list]):
        self.records = [list(r) for r in records]

    def _gen(self):
        yield from self.records


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Iterable[list]):
        self.sequences = [[list(r) for r in seq] for seq in sequences]

    def _gen(self):
        yield from self.sequences


class CSVRecordReader(RecordReader):
    """CSV rows -> records (reference: CSVRecordReader — skip lines +
    delimiter).

    Purely numeric files take the port's native C parser
    (``deeplearning4j_torch/native``, byte-identical to the JAX package's
    ``fastio.c``); anything the fast path cannot represent (string fields,
    ragged rows) falls back to the Python csv module, as in the JAX
    package."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def read_numeric(self):
        """Whole-file bulk parse -> float64 [rows, cols] ndarray, or None
        when the file is not purely numeric (or no native lib)."""
        from deeplearning4j_torch.native import parse_numeric_csv
        return parse_numeric_csv(self.path, self.delimiter, self.skip_lines)

    def _gen(self):
        arr = self.read_numeric()
        if arr is not None:
            # tolist() converts to builtin floats in one C pass
            yield from arr.tolist()
            return
        with open(self.path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [_maybe_float(v) for v in row]


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (reference: CSVSequenceRecordReader over a
    file split). ``paths`` may be a directory (sorted files) or a list."""

    def __init__(self, paths, skip_lines: int = 0, delimiter: str = ","):
        if isinstance(paths, str):
            self.paths = [os.path.join(paths, f)
                          for f in sorted(os.listdir(paths))]
        else:
            self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def _gen(self):
        for p in self.paths:
            seq = list(CSVRecordReader(p, self.skip_lines, self.delimiter))
            if seq:
                yield seq


class ImageRecordReader(RecordReader):
    """Image files -> [h, w, c] float arrays + label from parent directory
    (reference: ImageRecordReader + ParentPathLabelGenerator). NHWC, scaled
    to [0, 1]. Decoding needs PIL (Pillow), imported when the reader is
    iterated; without it iteration raises an ``ImportError`` naming PIL."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 root: Optional[str] = None, paths: Optional[list] = None,
                 labels: Optional[list] = None):
        self.height = height
        self.width = width
        self.channels = channels
        if root is not None:
            self.paths = []
            for d in sorted(os.listdir(root)):
                full = os.path.join(root, d)
                if os.path.isdir(full):
                    for f in sorted(os.listdir(full)):
                        self.paths.append((os.path.join(full, f), d))
            self.labels = sorted({lab for _, lab in self.paths})
        else:
            self.paths = [(p, lab) for p, lab in zip(paths, labels)]
            self.labels = sorted(set(labels))
        self._label_idx = {l: i for i, l in enumerate(self.labels)}

    def num_labels(self) -> int:
        return len(self.labels)

    def _gen(self):
        import numpy as np
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "ImageRecordReader needs PIL (the Pillow package) to decode "
                "image files, and it is not installed") from e

        for path, lab in self.paths:
            img = Image.open(path)
            img = img.convert("RGB" if self.channels == 3 else "L")
            img = img.resize((self.width, self.height))
            arr = np.asarray(img, np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[:, :, None]
            yield [arr, self._label_idx[lab]]


def _maybe_float(v: str):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
