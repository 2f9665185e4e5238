"""Streaming ingestion (port of ``deeplearning4j_tpu/datasets/streaming.py``,
host-side, no device work): a thread-safe push queue a producer thread
feeds (a broker consumer), a pull iterator the training loop drains with
bounded-buffer backpressure, and per-example → minibatch collation."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Optional

import numpy as np

from deeplearning4j_torch.datasets.dataset import DataSet
from deeplearning4j_torch.datasets.iterators import DataSetIterator

_DONE = object()


class QueueDataSetIterator(DataSetIterator):
    """Push side for producers, iterator side for training.

    A producer calls ``put(ds)`` per arriving minibatch and ``end()`` when
    the stream closes; ``put`` blocks once ``maxsize`` batches are
    buffered. Single-pass: ``reset`` is a no-op, as a stream has no
    beginning to return to."""

    def __init__(self, maxsize: int = 16):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._ended = threading.Event()

    def put(self, ds: DataSet, timeout: Optional[float] = None) -> None:
        if self._ended.is_set():
            raise RuntimeError("stream already ended")
        self._q.put(ds, timeout=timeout)

    def end(self) -> None:
        """Close the stream without blocking: the flag is what the
        consumer polls; the sentinel only wakes a consumer parked in
        ``get`` (skipped when the buffer is full, when none is parked)."""
        self._ended.set()
        try:
            self._q.put_nowait(_DONE)
        except queue.Full:
            pass

    def _iterate(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._ended.is_set():
                    return          # drained after end(): later passes end
                continue
            if item is _DONE:
                return
            yield item

    def reset(self):  # single-pass stream
        pass


class StreamingDataSetIterator(DataSetIterator):
    """Pulls DataSets from any iterable (a socket reader, a file tailer, a
    generator polling a queue), at most ``max_batches`` per pass; the next
    pass continues the stream where the last stopped."""

    def __init__(self, source: Iterable, max_batches: Optional[int] = None):
        self.source = source
        self.max_batches = max_batches
        self._it = None

    def _iterate(self):
        if self._it is None:
            self._it = iter(self.source)
        n = 0
        for ds in self._it:
            yield ds
            n += 1
            if self.max_batches is not None and n >= self.max_batches:
                return

    def reset(self):
        # a stream continues; it has no start to return to
        pass


class ExampleCollator:
    """Collates single examples into ``batch_size`` minibatches: ``add``
    returns (and sends to ``sink``) each completed batch, ``flush`` the
    trailing partial one."""

    def __init__(self, batch_size: int,
                 sink: Optional[QueueDataSetIterator] = None):
        self.batch_size = batch_size
        self.sink = sink
        self._f: list = []
        self._l: list = []
        self._lock = threading.Lock()

    def _emit(self) -> DataSet:
        ds = DataSet(np.stack(self._f), np.stack(self._l))
        self._f, self._l = [], []
        return ds

    def add(self, features, label) -> Optional[DataSet]:
        with self._lock:
            self._f.append(np.asarray(features))
            self._l.append(np.asarray(label))
            if len(self._f) < self.batch_size:
                return None
            ds = self._emit()
        if self.sink is not None:
            self.sink.put(ds)
        return ds

    def flush(self) -> Optional[DataSet]:
        with self._lock:
            if not self._f:
                return None
            ds = self._emit()
        if self.sink is not None:
            self.sink.put(ds)
        return ds
