"""MNIST (port of ``deeplearning4j_tpu/datasets/mnist.py``, which imports no
JAX; the port keeps its own copy): ``MnistDataSetIterator`` over flat
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
