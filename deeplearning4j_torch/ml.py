"""Estimator-protocol wrappers over the port's nets (port of
``deeplearning4j_tpu/ml.py``): scikit-learn's ``fit``/``predict``/
``score`` and ``get_params``/``set_params`` duck type, so a network drops
into a Pipeline or a grid search. sklearn's base classes are used when it
is installed, plain bases otherwise; nothing here needs it.

``device`` (a constructor parameter, so ``clone`` keeps it) is where each
fit builds its net: CUDA unless the caller names another device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

try:  # sklearn's bases when available (tags, clone, check_is_fitted)
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
except ImportError:
    class BaseEstimator:  # type: ignore[no-redef]
        pass

    class ClassifierMixin:  # type: ignore[no-redef]
        pass

    class RegressorMixin:  # type: ignore[no-redef]
        pass


def _host(out) -> np.ndarray:
    if isinstance(out, (list, tuple)):
        out = out[0]
    return out.detach().cpu().numpy()


class DL4JEstimator(BaseEstimator):
    """Wraps a configuration factory ``() -> built configuration``; each
    ``fit`` builds a fresh net (sklearn's semantics: fit resets) and trains
    it ``epochs`` passes over ``batch_size`` minibatches."""

    def __init__(self, conf_factory: Callable, epochs: int = 10,
                 batch_size: int = 32, device=None):
        self.conf_factory = conf_factory
        self.epochs = epochs
        self.batch_size = batch_size
        self.device = device
        self.net_ = None

    def get_params(self, deep: bool = True) -> dict:
        return {"conf_factory": self.conf_factory, "epochs": self.epochs,
                "batch_size": self.batch_size, "device": self.device}

    def set_params(self, **params) -> "DL4JEstimator":
        valid = self.get_params()
        for k, v in params.items():
            if k not in valid:      # constructor parameters only
                raise ValueError(f"Invalid parameter {k}")
            setattr(self, k, v)
        return self

    def _fit_net(self, x, y):
        from deeplearning4j_torch.datasets.dataset import DataSet
        from deeplearning4j_torch.datasets.iterators import (
            ListDataSetIterator)
        from deeplearning4j_torch.nn.graph import ComputationGraph
        from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

        conf = self.conf_factory()
        net_cls = (ComputationGraph if hasattr(conf, "vertices")
                   else MultiLayerNetwork)
        self.net_ = net_cls(conf).init(device=self.device)
        self.net_.fit(ListDataSetIterator(DataSet(x, y),
                                          batch_size=self.batch_size),
                      epochs=self.epochs)
        return self

    def _check_fitted(self):
        if self.net_ is None:
            raise RuntimeError("Estimator is not fitted; call fit first")


class DL4JClassifier(ClassifierMixin, DL4JEstimator):
    """Classifier over a softmax-output net; ``y`` class labels ``[N]``
    (any sortable values) or one-hot ``[N, C]``."""

    def fit(self, x, y) -> "DL4JClassifier":
        x = np.asarray(x)
        y = np.asarray(y)
        if y.ndim == 1:
            self.classes_ = np.unique(y)
            onehot = np.zeros((y.size, self.classes_.size), np.float32)
            onehot[np.arange(y.size),
                   np.searchsorted(self.classes_, y)] = 1.0
            y = onehot
        else:
            self.classes_ = np.arange(y.shape[1])
        return self._fit_net(x, y)

    def predict_proba(self, x) -> np.ndarray:
        self._check_fitted()
        return _host(self.net_.output(np.asarray(x)))

    def predict(self, x) -> np.ndarray:
        proba = self.predict_proba(x)      # raises if unfitted
        return self.classes_[np.argmax(proba, axis=-1)]

    def score(self, x, y) -> float:
        """Mean accuracy (the sklearn classifier contract)."""
        return float(np.mean(self.predict(x) == np.asarray(y)))


class DL4JRegressor(RegressorMixin, DL4JEstimator):
    """Regressor over an identity-output net; ``y`` ``[N]`` or
    ``[N, K]``."""

    def fit(self, x, y) -> "DL4JRegressor":
        x = np.asarray(x)
        y = np.asarray(y, np.float32)
        self._squeeze = y.ndim == 1
        if self._squeeze:
            y = y[:, None]
        return self._fit_net(x, y)

    def predict(self, x) -> np.ndarray:
        self._check_fitted()
        out = _host(self.net_.output(np.asarray(x)))
        return out[:, 0] if self._squeeze and out.ndim == 2 else out

    def score(self, x, y) -> float:
        """R² (the sklearn regressor contract)."""
        y = np.asarray(y, np.float64)
        pred = np.asarray(self.predict(x), np.float64)
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y)) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot else 0.0
