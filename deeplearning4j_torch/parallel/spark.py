"""Cluster-style training facade: TrainingMaster + Spark-like wrappers
(port of ``deeplearning4j_tpu/parallel/spark.py``).

Reference: dl4j-spark — TrainingMaster SPI (spark/api/TrainingMaster.java),
ParameterAveragingTrainingMaster.java:367-490 (split the RDD, broadcast the
net, per-worker minibatch loops, treeAggregate, then params/updater
divided by the count), SparkDl4jMultiLayer / SparkComputationGraph
(distributed evaluation :443-540).

The "cluster" is a data mesh: an RDD of DataSets is a host-side list or
iterator partitioned into per-round worker groups, and "broadcast +
treeAggregate-average" is one ``ParallelWrapper`` averaging round (the
port's ``pmean`` over the workers' devices, in mesh order).
``averaging_frequency`` maps to the reference's batchSizePerWorker *
averagingFrequency; ``rdd_data_set_num_examples`` and
``workers_per_node`` collapse into the mesh size. With
``averaging_frequency=1`` this equals one machine training on the
concatenated batches (TestCompareParameterAveragingSparkVsSingleMachine).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from deeplearning4j_torch.parallel.evaluation import evaluate_on_mesh
from deeplearning4j_torch.parallel.mesh import Mesh, data_mesh
from deeplearning4j_torch.parallel.trainer import AVERAGING, ParallelWrapper

# Repartition strategies (reference: spark/api/Repartition.java)
REPARTITION_ALWAYS = "always"
REPARTITION_NEVER = "never"


def repartition_datasets(data, batch_size: int,
                         strategy: str = REPARTITION_ALWAYS):
    """Balance-if-required (reference:
    SparkUtils.repartitionBalanceIfRequired): uniform incoming minibatches
    are kept; otherwise ALL examples are re-split into uniform
    ``batch_size`` minibatches (the tail last), so every worker round
    sees same-shaped batches and no mid-stream odd batch is dropped."""
    if strategy == REPARTITION_NEVER:
        return list(data)
    from deeplearning4j_torch.datasets.dataset import DataSet

    data = list(data)
    if not data:
        return data
    sizes = {int(np.shape(d.features)[0]) for d in data}
    if len(sizes) == 1:
        return data  # already balanced
    if any(d.features_mask is not None or d.labels_mask is not None
           for d in data):
        # masked (variable-length) data: element moves would need mask
        # re-padding; keep caller batching
        return data
    feats = np.concatenate([np.asarray(d.features) for d in data])
    labels = np.concatenate([np.asarray(d.labels) for d in data])
    n = feats.shape[0]
    out = []
    for s in range(0, n - n % batch_size, batch_size):
        out.append(DataSet(feats[s:s + batch_size],
                           labels[s:s + batch_size]))
    tail = n % batch_size
    if tail:
        out.append(DataSet(feats[n - tail:], labels[n - tail:]))
    return out


class TrainingMaster:
    """SPI (reference: spark/api/TrainingMaster.java:29)."""

    def execute_training(self, net, data) -> None:
        raise NotImplementedError


class ParameterAveragingTrainingMaster(TrainingMaster):
    """reference: impl/paramavg/ParameterAveragingTrainingMaster.java.
    ``repartition='always'`` balances if required (uniform minibatches are
    kept as the round unit; only ragged unmasked data is re-sliced into
    ``batch_size_per_worker`` rows); ``'never'`` trusts caller batching.
    ``aggregation_depth`` (Spark's treeAggregate fan-in) has no effect:
    averaging is one ``pmean`` in mesh order, so a value other than the
    default warns rather than silently pretending. ``mesh`` defaults to
    ``data_mesh(workers)`` (every CUDA device)."""

    def __init__(self, batch_size_per_worker: int = 16,
                 averaging_frequency: int = 1,
                 aggregation_depth: int = 2,
                 average_updaters: bool = True,
                 repartition: str = REPARTITION_ALWAYS,
                 mesh: Optional[Mesh] = None,
                 workers: Optional[int] = None):
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = averaging_frequency
        if aggregation_depth != 2:
            warnings.warn(
                "aggregation_depth has no effect on a device mesh: "
                "averaging is one pmean over the workers' devices in mesh "
                "order", stacklevel=2)
        self.aggregation_depth = aggregation_depth
        self.average_updaters = average_updaters
        if repartition not in (REPARTITION_ALWAYS, REPARTITION_NEVER):
            raise ValueError(f"Unknown repartition '{repartition}'")
        self.repartition = repartition
        self.mesh = mesh if mesh is not None else data_mesh(workers)

    def execute_training(self, net, data) -> None:
        """data: an iterator/list of DataSets, or one DataSet re-batched
        to ``batch_size_per_worker`` (the Export and Direct RDD approaches
        both reduce to this)."""
        from deeplearning4j_torch.datasets.dataset import DataSet

        if isinstance(data, DataSet):
            data = list(data.batch_by(self.batch_size_per_worker))
        else:
            data = repartition_datasets(data, self.batch_size_per_worker,
                                        self.repartition)
        pw = ParallelWrapper(net, mesh=self.mesh, mode=AVERAGING,
                             averaging_frequency=self.averaging_frequency,
                             average_updaters=self.average_updaters)
        pw.fit(data)


class SparkDl4jMultiLayer:
    """reference: impl/multilayer/SparkDl4jMultiLayer.java — net + master
    facade with fit / evaluate."""

    def __init__(self, net, training_master: TrainingMaster):
        self.net = net
        self.master = training_master

    def fit(self, data, epochs: int = 1):
        for _ in range(epochs):
            self.master.execute_training(self.net, data)
        return self.net

    def evaluate(self, iterator, evaluation=None):
        """Distributed (map-reduce) evaluation (reference:
        SparkDl4jMultiLayer.java:443-540 -> IEvaluateFlatMapFunction +
        IEvaluation.merge)."""
        mesh = getattr(self.master, "mesh", None)
        return evaluate_on_mesh(self.net, iterator, mesh=mesh,
                                evaluation=evaluation)

    def get_network(self):
        return self.net


class SparkComputationGraph(SparkDl4jMultiLayer):
    """reference: impl/graph/SparkComputationGraph.java — the same facade;
    a ComputationGraph keeps the same training contract."""
