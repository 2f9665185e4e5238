"""Regression evaluation (a copy of
``deeplearning4j_tpu/evaluation/regression.py``, which imports no JAX; the
port keeps its own): per-column MSE, MAE, RMSE and R^2 from sufficient
statistics, mergeable, host numpy. ``[B, T, C]`` inputs count the steps the
labels mask keeps."""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None):
        self.n = 0
        self.num_columns = num_columns
        self._init_done = False

    def _ensure(self, c):
        if not self._init_done:
            self.num_columns = self.num_columns or c
            z = np.zeros(self.num_columns)
            self.sum_err2 = z.copy()
            self.sum_abs_err = z.copy()
            self.sum_l = z.copy()
            self.sum_p = z.copy()
            self.sum_l2 = z.copy()
            self.sum_p2 = z.copy()
            self.sum_lp = z.copy()
            self._init_done = True

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, float)
        predictions = np.asarray(predictions, float)
        if labels.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        self._ensure(labels.shape[-1])
        err = labels - predictions
        self.n += labels.shape[0]
        self.sum_err2 += (err ** 2).sum(axis=0)
        self.sum_abs_err += np.abs(err).sum(axis=0)
        self.sum_l += labels.sum(axis=0)
        self.sum_p += predictions.sum(axis=0)
        self.sum_l2 += (labels ** 2).sum(axis=0)
        self.sum_p2 += (predictions ** 2).sum(axis=0)
        self.sum_lp += (labels * predictions).sum(axis=0)
        return self

    def merge(self, other: "RegressionEvaluation"):
        if not getattr(other, "_init_done", False):
            return self
        if not self._init_done:
            self.__dict__.update({k: (v.copy() if isinstance(v, np.ndarray) else v)
                                  for k, v in other.__dict__.items()})
            return self
        self.n += other.n
        for k in ("sum_err2", "sum_abs_err", "sum_l", "sum_p", "sum_l2", "sum_p2",
                  "sum_lp"):
            setattr(self, k, getattr(self, k) + getattr(other, k))
        return self

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.sum_err2[col] / self.n))

    def correlation_r2(self, col: int) -> float:
        n = self.n
        num = n * self.sum_lp[col] - self.sum_l[col] * self.sum_p[col]
        den = (np.sqrt(n * self.sum_l2[col] - self.sum_l[col] ** 2)
               * np.sqrt(n * self.sum_p2[col] - self.sum_p[col] ** 2))
        return float((num / den) ** 2) if den else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err2 / self.n))

    def stats(self) -> str:
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in range(self.num_columns):
            lines.append(f"col_{c}    {self.mean_squared_error(c):<14.6f} "
                         f"{self.mean_absolute_error(c):<14.6f} "
                         f"{self.root_mean_squared_error(c):<14.6f} "
                         f"{self.correlation_r2(c):<10.6f}")
        return "\n".join(lines)
