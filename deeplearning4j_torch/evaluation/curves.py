"""Serializable evaluation curves (a copy of
``deeplearning4j_tpu/evaluation/curves.py``, which imports no JAX; the port
keeps its own): ``RocCurve``, ``PrecisionRecallCurve`` and ``Histogram``,
plain dataclasses whose ``to_json`` writes the JAX package's strings (strict
JSON: the ROC's +inf threshold is written as null) and whose ``from_json``
reads them back.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import List

import numpy as np

#: the trapezoid rule (``np.trapz`` before numpy 2.0)
trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _finite(xs):
    """Non-finite floats (ROC's +inf sentinel threshold) serialize as null:
    bare ``Infinity`` is invalid RFC 8259 JSON and strict consumers
    (browser JSON.parse, jq, Java) reject the whole document."""
    return [None if isinstance(x, float) and not math.isfinite(x) else x
            for x in xs]


def _definite(xs):
    return [math.inf if x is None else x for x in xs]


@dataclass
class RocCurve:
    thresholds: List[float] = field(default_factory=list)
    fpr: List[float] = field(default_factory=list)
    tpr: List[float] = field(default_factory=list)

    def to_json(self) -> str:
        d = asdict(self)
        d["thresholds"] = _finite(d["thresholds"])
        return json.dumps({"@class": "RocCurve", **d}, allow_nan=False)

    @staticmethod
    def from_json(s: str) -> "RocCurve":
        d = json.loads(s)
        if d.pop("@class", "RocCurve") != "RocCurve":
            raise ValueError("not a RocCurve json")
        d["thresholds"] = _definite(d["thresholds"])
        return RocCurve(**d)

    def calculate_auc(self) -> float:
        fpr, tpr = np.asarray(self.fpr), np.asarray(self.tpr)
        order = np.argsort(fpr, kind="stable")
        return float(trapezoid(tpr[order], fpr[order]))


@dataclass
class PrecisionRecallCurve:
    thresholds: List[float] = field(default_factory=list)
    precision: List[float] = field(default_factory=list)
    recall: List[float] = field(default_factory=list)

    def to_json(self) -> str:
        d = asdict(self)
        d["thresholds"] = _finite(d["thresholds"])
        return json.dumps({"@class": "PrecisionRecallCurve", **d},
                          allow_nan=False)

    @staticmethod
    def from_json(s: str) -> "PrecisionRecallCurve":
        d = json.loads(s)
        if d.pop("@class", "PrecisionRecallCurve") != "PrecisionRecallCurve":
            raise ValueError("not a PrecisionRecallCurve json")
        d["thresholds"] = _definite(d["thresholds"])
        return PrecisionRecallCurve(**d)

    def calculate_auprc(self) -> float:
        rec, prec = np.asarray(self.recall), np.asarray(self.precision)
        order = np.argsort(rec, kind="stable")
        return float(trapezoid(prec[order], rec[order]))


@dataclass
class Histogram:
    """Field names match the dicts StatsListener._histograms emits and the
    UI histogram page consumes ({counts, min, max}), so a pipeline
    histogram round-trips through this class unchanged."""

    title: str = ""
    min: float = 0.0
    max: float = 1.0
    counts: List[int] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({"@class": "Histogram", **asdict(self)})

    @staticmethod
    def from_json(s: str) -> "Histogram":
        d = json.loads(s)
        if d.pop("@class", "Histogram") != "Histogram":
            raise ValueError("not a Histogram json")
        return Histogram(**d)

    @staticmethod
    def from_stats(title: str, d: dict) -> "Histogram":
        """Wrap one StatsListener param_histograms entry."""
        return Histogram(title=title, min=d["min"], max=d["max"],
                         counts=list(d["counts"]))
