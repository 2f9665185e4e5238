"""CIFAR-10 and LFW iterators (port of
``deeplearning4j_tpu/datasets/cifar.py``, which imports no JAX; the port
keeps its own copy).

Both read the standard on-disk formats when present (CIFAR-10's binary
batches; LFW as one directory of images per person, read by
``datavec``'s ``ImageRecordReader``, which decodes with PIL) and
otherwise make the JAX package's deterministic synthetic sets
(class-conditioned colour and texture fields a CNN can learn), the same
arrays for the same arguments. Images are NHWC in [0, 1] with one-hot
labels.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.iterators import ListDataSetIterator

CIFAR_LABELS = ["airplane", "automobile", "bird", "cat", "deer", "dog",
                "frog", "horse", "ship", "truck"]


def _find_cifar(path: Optional[str]):
    cands = [p for p in (path, os.environ.get("CIFAR_DIR"),
                         os.path.expanduser("~/.cifar"),
                         os.path.expanduser("~/cifar-10-batches-bin")) if p]
    for d in cands:
        if os.path.exists(os.path.join(d, "data_batch_1.bin")):
            return d
    return None


def _read_cifar_bin(path: str):
    """One CIFAR-10 binary batch: rows of [label, 3072 bytes CHW]."""
    raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int64)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    return imgs.astype(np.float32) / 255.0, labels


def synthetic_cifar(n: int, seed: int = 7) -> DataSet:
    """Deterministic 32 × 32 × 3 10-class data: each class a dominant hue
    and an oriented texture frequency, plus noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    xs = np.zeros((n, 32, 32, 3), np.float32)
    for cls in range(10):
        idx = np.where(labels == cls)[0]
        if idx.size == 0:
            continue
        hue = np.array([((cls * 37) % 10) / 10.0,
                        ((cls * 53) % 10) / 10.0,
                        ((cls * 71) % 10) / 10.0], np.float32)
        freq = 2.0 + cls
        angle = cls * np.pi / 10.0
        wave = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (xx * np.cos(angle) + yy * np.sin(angle)))
        base = wave[..., None] * 0.6 + hue * 0.4
        noise = rng.normal(0, 0.07, (idx.size, 32, 32, 3)).astype(np.float32)
        xs[idx] = np.clip(base[None] + noise, 0, 1)
    return DataSet(xs, np.eye(10, dtype=np.float32)[labels])


class CifarDataSetIterator(ListDataSetIterator):
    """NHWC [B, 32, 32, 3] in [0, 1], one-hot labels [B, 10]."""

    def __init__(self, batch_size: int = 128, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 7,
                 path: Optional[str] = None, shuffle: bool = False):
        d = _find_cifar(path)
        if d is not None:
            files = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                     if train else ["test_batch.bin"])
            imgs, labels = zip(*[_read_cifar_bin(os.path.join(d, f))
                                 for f in files])
            imgs = np.concatenate(imgs)
            labels = np.concatenate(labels)
            if num_examples:
                imgs, labels = imgs[:num_examples], labels[:num_examples]
            ds = DataSet(imgs, np.eye(10, dtype=np.float32)[labels])
            self.synthetic = False
        else:
            n = num_examples or (50000 if train else 10000)
            ds = synthetic_cifar(n, seed=seed if train else seed + 1)
            self.synthetic = True
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle,
                         seed=seed)


def synthetic_lfw(n: int, num_people: int, size: int, seed: int = 11
                  ) -> DataSet:
    """Face-like synthetic data: per-person ellipse geometry and tone."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_people, n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    xs = np.zeros((n, size, size, 3), np.float32)
    for p in range(num_people):
        idx = np.where(labels == p)[0]
        if idx.size == 0:
            continue
        cx = 0.35 + 0.3 * ((p * 13) % num_people) / num_people
        cy = 0.35 + 0.3 * ((p * 29) % num_people) / num_people
        rx = 0.15 + 0.1 * ((p * 7) % num_people) / num_people
        ry = 0.2 + 0.1 * ((p * 17) % num_people) / num_people
        tone = 0.3 + 0.6 * ((p * 31) % num_people) / num_people
        face = np.exp(-(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2))
        img = np.stack([face * tone, face * (1 - tone * 0.5),
                        face * (0.5 + tone * 0.3)], axis=-1)
        noise = rng.normal(0, 0.05,
                           (idx.size, size, size, 3)).astype(np.float32)
        xs[idx] = np.clip(img[None] + noise, 0, 1)
    return DataSet(xs, np.eye(num_people, dtype=np.float32)[labels])


class LFWDataSetIterator(ListDataSetIterator):
    """Labeled-faces-in-the-wild-style iterator: person-per-directory
    images when ``path`` is a directory, the synthetic set otherwise."""

    def __init__(self, batch_size: int = 32, num_examples: int = 512,
                 image_size: int = 64, num_people: int = 10,
                 path: Optional[str] = None, seed: int = 11,
                 shuffle: bool = False):
        if path is not None and os.path.isdir(path):
            from deeplearning4j_torch.datavec.records import (
                ImageRecordReader)
            rr = ImageRecordReader(image_size, image_size, 3, root=path)
            feats, labs = [], []
            for arr, lab in rr:
                feats.append(arr)
                labs.append(lab)
                if len(feats) >= num_examples:
                    break
            x = np.stack(feats)
            y = np.eye(rr.num_labels(), dtype=np.float32)[labs]
            ds = DataSet(x, y)
            self.synthetic = False
        else:
            ds = synthetic_lfw(num_examples, num_people, image_size,
                               seed=seed)
            self.synthetic = True
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle,
                         seed=seed)
