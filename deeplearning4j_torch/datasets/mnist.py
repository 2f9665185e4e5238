"""MNIST and Iris (port of ``deeplearning4j_tpu/datasets/mnist.py``, which
imports no JAX; the port keeps its own copy): ``IrisDataSetIterator`` over
the embedded 150 Iris rows, and ``MnistDataSetIterator`` over flat
``[B, 784]`` features in [0, 1] and one-hot ``[B, 10]`` labels. It reads
the standard IDX files from ``path`` or ``MNIST_DIR`` when they are
there; otherwise it makes the JAX package's deterministic synthetic
digit-like set (class-dependent oriented bars and blobs plus noise), the
same arrays for the same arguments, so training and tests run offline.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.iterators import ListDataSetIterator

_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack(">I", data[:4])
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find_files(path: Optional[str], train: bool):
    candidates = [p for p in (path, os.environ.get("MNIST_DIR")) if p]
    img_name, lab_name = _FILES[train]
    for d in candidates:
        for suffix in ("", ".gz"):
            img = os.path.join(d, img_name + suffix)
            lab = os.path.join(d, lab_name + suffix)
            if os.path.exists(img) and os.path.exists(lab):
                return img, lab
    return None


def synthetic_mnist(n: int, seed: int = 123) -> DataSet:
    """Deterministic synthetic 28x28 10-class digit-like data.

    Each class is a distinct combination of an oriented bar and a blob position,
    plus pixel noise — linearly non-trivial, conv-learnable.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    xs = np.zeros((n, 28, 28), np.float32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    for cls in range(10):
        idx = np.where(labels == cls)[0]
        if len(idx) == 0:
            continue
        angle = cls * np.pi / 10.0
        cx = 8.0 + 12.0 * ((cls * 7) % 10) / 10.0
        cy = 8.0 + 12.0 * ((cls * 3) % 10) / 10.0
        d = np.abs((xx - 14) * np.sin(angle) - (yy - 14) * np.cos(angle))
        bar = np.exp(-(d ** 2) / 6.0)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)) / 12.0)
        base = np.clip(bar + blob, 0, 1)
        jitter = rng.normal(0, 0.08, (len(idx), 28, 28)).astype(np.float32)
        shifts = rng.integers(-2, 3, (len(idx), 2))
        for j, i in enumerate(idx):
            img = np.roll(np.roll(base, shifts[j, 0], axis=0), shifts[j, 1], axis=1)
            xs[i] = np.clip(img + jitter[j], 0, 1)
    one_hot = np.eye(10, dtype=np.float32)[labels]
    return DataSet(xs.reshape(n, 784), one_hot)


class MnistDataSetIterator(ListDataSetIterator):
    """Flat [B, 784] features in [0,1], one-hot labels [B, 10].

    Matches the reference iterator's output contract
    (MnistDataSetIterator.java: binarize=false, normalize to [0,1]).
    """

    def __init__(self, batch_size: int = 128, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 123,
                 path: Optional[str] = None, shuffle: bool = False):
        found = _find_files(path, train)
        if found is not None:
            imgs = _read_idx(found[0]).astype(np.float32) / 255.0
            labs = _read_idx(found[1]).astype(np.int64)
            if num_examples:
                imgs, labs = imgs[:num_examples], labs[:num_examples]
            ds = DataSet(imgs.reshape(len(imgs), -1), np.eye(10, dtype=np.float32)[labs])
            self.synthetic = False
        else:
            n = num_examples or (60000 if train else 10000)
            ds = synthetic_mnist(n, seed=seed if train else seed + 1)
            self.synthetic = True
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle, seed=seed)


class IrisDataSetIterator(ListDataSetIterator):
    """The classic Iris dataset, embedded (150 rows, three classes of
    fifty), features standardised, rows in ``default_rng(seed)``'s
    permutation, one-hot labels."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 seed: int = 42):
        x, y = _iris_data()
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(x))[:num_examples]
        x = (x - x.mean(axis=0)) / x.std(axis=0)
        ds = DataSet(x[idx].astype(np.float32),
                     np.eye(3, dtype=np.float32)[y[idx]])
        super().__init__(ds, batch_size=batch_size)


def _iris_data():
    # Fisher's iris measurements (sepal l/w, petal l/w), classes 0/1/2 x 50:
    # the canonical 150 rows
    raw = (
        "5.1,3.5,1.4,.2;4.9,3,1.4,.2;4.7,3.2,1.3,.2;4.6,3.1,1.5,.2;5,3.6,1.4,.2;"
        "5.4,3.9,1.7,.4;4.6,3.4,1.4,.3;5,3.4,1.5,.2;4.4,2.9,1.4,.2;4.9,3.1,1.5,.1;"
        "5.4,3.7,1.5,.2;4.8,3.4,1.6,.2;4.8,3,1.4,.1;4.3,3,1.1,.1;5.8,4,1.2,.2;"
        "5.7,4.4,1.5,.4;5.4,3.9,1.3,.4;5.1,3.5,1.4,.3;5.7,3.8,1.7,.3;5.1,3.8,1.5,.3;"
        "5.4,3.4,1.7,.2;5.1,3.7,1.5,.4;4.6,3.6,1,.2;5.1,3.3,1.7,.5;4.8,3.4,1.9,.2;"
        "5,3,1.6,.2;5,3.4,1.6,.4;5.2,3.5,1.5,.2;5.2,3.4,1.4,.2;4.7,3.2,1.6,.2;"
        "4.8,3.1,1.6,.2;5.4,3.4,1.5,.4;5.2,4.1,1.5,.1;5.5,4.2,1.4,.2;4.9,3.1,1.5,.2;"
        "5,3.2,1.2,.2;5.5,3.5,1.3,.2;4.9,3.6,1.4,.1;4.4,3,1.3,.2;5.1,3.4,1.5,.2;"
        "5,3.5,1.3,.3;4.5,2.3,1.3,.3;4.4,3.2,1.3,.2;5,3.5,1.6,.6;5.1,3.8,1.9,.4;"
        "4.8,3,1.4,.3;5.1,3.8,1.6,.2;4.6,3.2,1.4,.2;5.3,3.7,1.5,.2;5,3.3,1.4,.2;"
        "7,3.2,4.7,1.4;6.4,3.2,4.5,1.5;6.9,3.1,4.9,1.5;5.5,2.3,4,1.3;6.5,2.8,4.6,1.5;"
        "5.7,2.8,4.5,1.3;6.3,3.3,4.7,1.6;4.9,2.4,3.3,1;6.6,2.9,4.6,1.3;5.2,2.7,3.9,1.4;"
        "5,2,3.5,1;5.9,3,4.2,1.5;6,2.2,4,1;6.1,2.9,4.7,1.4;5.6,2.9,3.6,1.3;"
        "6.7,3.1,4.4,1.4;5.6,3,4.5,1.5;5.8,2.7,4.1,1;6.2,2.2,4.5,1.5;5.6,2.5,3.9,1.1;"
        "5.9,3.2,4.8,1.8;6.1,2.8,4,1.3;6.3,2.5,4.9,1.5;6.1,2.8,4.7,1.2;6.4,2.9,4.3,1.3;"
        "6.6,3,4.4,1.4;6.8,2.8,4.8,1.4;6.7,3,5,1.7;6,2.9,4.5,1.5;5.7,2.6,3.5,1;"
        "5.5,2.4,3.8,1.1;5.5,2.4,3.7,1;5.8,2.7,3.9,1.2;6,2.7,5.1,1.6;5.4,3,4.5,1.5;"
        "6,3.4,4.5,1.6;6.7,3.1,4.7,1.5;6.3,2.3,4.4,1.3;5.6,3,4.1,1.3;5.5,2.5,4,1.3;"
        "5.5,2.6,4.4,1.2;6.1,3,4.6,1.4;5.8,2.6,4,1.2;5,2.3,3.3,1;5.6,2.7,4.2,1.3;"
        "5.7,3,4.2,1.2;5.7,2.9,4.2,1.3;6.2,2.9,4.3,1.3;5.1,2.5,3,1.1;5.7,2.8,4.1,1.3;"
        "6.3,3.3,6,2.5;5.8,2.7,5.1,1.9;7.1,3,5.9,2.1;6.3,2.9,5.6,1.8;6.5,3,5.8,2.2;"
        "7.6,3,6.6,2.1;4.9,2.5,4.5,1.7;7.3,2.9,6.3,1.8;6.7,2.5,5.8,1.8;7.2,3.6,6.1,2.5;"
        "6.5,3.2,5.1,2;6.4,2.7,5.3,1.9;6.8,3,5.5,2.1;5.7,2.5,5,2;5.8,2.8,5.1,2.4;"
        "6.4,3.2,5.3,2.3;6.5,3,5.5,1.8;7.7,3.8,6.7,2.2;7.7,2.6,6.9,2.3;6,2.2,5,1.5;"
        "6.9,3.2,5.7,2.3;5.6,2.8,4.9,2;7.7,2.8,6.7,2;6.3,2.7,4.9,1.8;6.7,3.3,5.7,2.1;"
        "7.2,3.2,6,1.8;6.2,2.8,4.8,1.8;6.1,3,4.9,1.8;6.4,2.8,5.6,2.1;7.2,3,5.8,1.6;"
        "7.4,2.8,6.1,1.9;7.9,3.8,6.4,2;6.4,2.8,5.6,2.2;6.3,2.8,5.1,1.5;6.1,2.6,5.6,1.4;"
        "7.7,3,6.1,2.3;6.3,3.4,5.6,2.4;6.4,3.1,5.5,1.8;6,3,4.8,1.8;6.9,3.1,5.4,2.1;"
        "6.7,3.1,5.6,2.4;6.9,3.1,5.1,2.3;5.8,2.7,5.1,1.9;6.8,3.2,5.9,2.3;6.7,3.3,5.7,2.5;"
        "6.7,3,5.2,2.3;6.3,2.5,5,1.9;6.5,3,5.2,2;6.2,3.4,5.4,2.3;5.9,3,5.1,1.8"
    )
    x = np.array([[float(v) for v in row.split(",")] for row in raw.split(";")])
    y = np.repeat(np.arange(3), 50)
    return x, y
