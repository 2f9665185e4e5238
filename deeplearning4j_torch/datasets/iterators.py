"""DataSet iterators (port of the in-memory part of
``deeplearning4j_tpu/datasets/iterators.py``): the ``DataSetIterator``
contract and ``ListDataSetIterator``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterable over DataSet minibatches; subclasses implement
    ``_iterate()``."""

    def __iter__(self):
        self.reset()
        return self._iterate()

    def _iterate(self):
        raise NotImplementedError

    def reset(self):
        pass

    def total_examples(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Batches over an in-memory DataSet or a list of DataSets (merged),
    in order or shuffled per epoch (``default_rng(seed + epoch)``)."""

    def __init__(self, data, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0):
        if isinstance(data, (list, tuple)):
            data = DataSet.merge(list(data))
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def _iterate(self):
        data = self.data
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch
                                          ).permutation(data.num_examples())
            self._epoch += 1
        else:
            order = np.arange(data.num_examples())
        for s in range(0, len(order), self.batch_size):
            yield data._rows(order[s:s + self.batch_size])

    def total_examples(self):
        return self.data.num_examples()
