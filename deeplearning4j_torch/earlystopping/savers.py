"""Model savers (port of the JAX package's ``earlystopping/savers.py``).

``InMemoryModelSaver`` keeps a clone (``Network.clone``, on the net's
device); ``LocalFileModelSaver`` writes ``bestModel.bin`` and
``latestModel.bin`` model zips with the port's ``save_model`` and reads
them back with ``load_model`` onto its ``device`` (CUDA unless the caller
passes another device), so either package reads what the other wrote.
"""

from __future__ import annotations

import os


class EarlyStoppingModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """reference: saver/InMemoryModelSaver.java"""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score: float) -> None:
        self._best = net.clone()

    def save_latest_model(self, net, score: float) -> None:
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """reference: saver/LocalFileModelSaver.java (bestModel.bin /
    latestModel.bin in a directory). Files are our model zips."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save_best_model(self, net, score: float) -> None:
        from deeplearning4j_torch.utils.model_serializer import save_model
        save_model(net, self._path("bestModel.bin"))

    def save_latest_model(self, net, score: float) -> None:
        from deeplearning4j_torch.utils.model_serializer import save_model
        save_model(net, self._path("latestModel.bin"))

    def _load(self, name: str):
        from deeplearning4j_torch.utils.model_serializer import load_model
        p = self._path(name)
        return (load_model(p, device=self.device) if os.path.exists(p)
                else None)

    def get_best_model(self):
        return self._load("bestModel.bin")

    def get_latest_model(self):
        return self._load("latestModel.bin")
