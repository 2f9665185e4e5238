"""DataSet iterators (port of ``deeplearning4j_tpu/datasets/iterators.py``):
the ``DataSetIterator`` contract, ``ListDataSetIterator``, the host-side
prefetch thread ``AsyncDataSetIterator``, the device prefetch
``DevicePrefetchIterator``, ``MultipleEpochsIterator`` and
``SamplingDataSetIterator``."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.optimize.fused_fit import device_put_ahead


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


def _base_iter(base):
    return (base._iterate() if isinstance(base, DataSetIterator)
            else iter(base))


class AsyncDataSetIterator(DataSetIterator):
    """Produces the base iterator's batches on a background thread into a
    bounded queue, so batch production overlaps the training step. An
    error in the producer is raised in the consumer; the thread is joined
    when the pass ends, also when the consumer stops early."""

    def __init__(self, base: Iterable, queue_size: int = 4):
        self.base = base
        self.queue_size = queue_size

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def _iterate(self):
        q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        done = object()
        err: list = []
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for ds in _base_iter(self.base):
                    if not put(ds):
                        return
            except BaseException as e:  # raised on the consumer's side
                err.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]

    def total_examples(self):
        return (self.base.total_examples()
                if hasattr(self.base, "total_examples") else None)


class DevicePrefetchIterator(DataSetIterator):
    """Keeps the next ``depth`` minibatches already on the device while the
    current one trains (``optimize/fused_fit.py::device_put_ahead`` issues
    the copies ahead of use).

    On CUDA each batch's arrays go through pinned host memory as
    non-blocking copies on a side stream, so they overlap the running
    step; an event recorded after them is waited on by the consumer's
    stream when the batch is handed out, and each tensor is marked used
    on that stream (``record_stream``), so no kernel reads a half-copied
    batch and the allocator does not reuse its memory early. On the CPU
    the arrays are wrapped without a copy. ``device`` is CUDA unless the
    caller names another.

    ``sharding`` (a ``parallel/mesh.py::DataSharding``, for example
    ``model_sharding.data_batch_sharding(mesh)``) places each batch for
    mesh training instead: every array is split on axis 0 into one piece
    per data device (a side stream of its own per card) and handed out as
    a ``ShardedArray``. A batch that does not split evenly (a trailing
    partial batch) raises ``ValueError`` when it is placed."""

    def __init__(self, base: Iterable, depth: int = 2, sharding=None,
                 device=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.base = base
        self.depth = depth
        self.sharding = sharding
        if sharding is not None:
            from deeplearning4j_torch.parallel.mesh import DataSharding

            if not isinstance(sharding, DataSharding):
                raise TypeError(f"sharding must be a parallel.mesh."
                                f"DataSharding, got "
                                f"{type(sharding).__name__}")
            first = sharding.devices[0]
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device={device} disagrees with the "
                                 f"sharding's first device {first}")
            self.device = first
        else:
            self.device = resolve_device(device)
        self._streams: dict = {}

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def _copy(self, t, dev):
        """``t`` onto ``dev``: a non-blocking copy on ``dev``'s side stream
        for a card, a plain ``to`` elsewhere."""
        if dev.type != "cuda":
            return t.to(dev)
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._streams[dev]):
            return t.to(dev, non_blocking=True)

    def _put(self, ds):
        from deeplearning4j_torch.parallel.mesh import ShardedArray

        arrs = (ds.features, ds.labels, ds.features_mask, ds.labels_mask)
        devices = ([self.device] if self.sharding is None
                   else self.sharding.devices)
        cuda = any(d.type == "cuda" for d in devices)
        if self.sharding is not None:
            # fail here, naming the batch: a trailing partial batch the
            # mesh cannot split would otherwise surface `depth` batches
            # away from the offending data
            try:
                self.sharding.shard_shape(tuple(np.shape(arrs[0])))
            except ValueError as e:
                raise ValueError(
                    f"batch shape {tuple(np.shape(arrs[0]))} is not "
                    f"divisible onto sharding {self.sharding} (trailing "
                    "partial batch? drop it or pad before prefetching)"
                ) from e

        def host(a):
            if torch.is_tensor(a):
                return a
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory() if cuda else t

        placed = []
        for a in arrs:
            if a is None:
                placed.append(None)
                continue
            pieces = [self._copy(p, d) for p, d in zip(
                host(a).chunk(len(devices)), devices)]
            placed.append(pieces[0] if self.sharding is None
                          else ShardedArray(pieces, self.sharding))
        ready = []
        for dev, stream in self._streams.items():
            event = torch.cuda.Event()
            event.record(stream)
            ready.append((dev, event))
        return tuple(placed), ready

    def _iterate(self):
        for placed, ready in device_put_ahead(_base_iter(self.base),
                                              self.depth, self._put):
            for dev, event in ready:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                for a in placed:
                    pieces = [] if a is None else getattr(a, "pieces", [a])
                    for t in pieces:
                        if t.device == dev:
                            t.record_stream(consumer)
            yield DataSet.on_device(*placed)

    def total_examples(self):
        return (self.base.total_examples()
                if hasattr(self.base, "total_examples") else None)


class MultipleEpochsIterator(DataSetIterator):
    """Replays a base iterator ``num_epochs`` times as one pass."""

    def __init__(self, base: DataSetIterator, num_epochs: int):
        self.base = base
        self.num_epochs = num_epochs

    def reset(self):
        self.base.reset()

    def _iterate(self):
        for _ in range(self.num_epochs):
            self.base.reset()
            yield from self.base._iterate()


class SamplingDataSetIterator(DataSetIterator):
    """``total_batches`` batches sampled with replacement from a DataSet
    (numpy's ``default_rng(seed + pass)``, the JAX package's draws)."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.total_batches = total_batches
        self.seed = seed
        self._calls = 0

    def _iterate(self):
        rng = np.random.default_rng(self.seed + self._calls)
        self._calls += 1
        n = self.data.num_examples()
        for _ in range(self.total_batches):
            idx = rng.integers(0, n, self.batch_size)
            yield DataSet(self.data.features[idx], self.data.labels[idx])
