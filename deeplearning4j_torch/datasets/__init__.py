"""Datasets (port of ``deeplearning4j_tpu/datasets``): the DataSet
containers, the iterators, streaming ingestion and the built-in sets,
under the JAX package's names."""

from deeplearning4j_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.datasets.iterators import (
    AsyncDataSetIterator,
    DataSetIterator,
    DevicePrefetchIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
)
from deeplearning4j_torch.datasets.streaming import (
    ExampleCollator,
    QueueDataSetIterator,
    StreamingDataSetIterator,
)
from deeplearning4j_torch.datasets.curves import CurvesDataSetIterator

__all__ = ["AsyncDataSetIterator", "CurvesDataSetIterator", "DataSet",
           "DataSetIterator", "DevicePrefetchIterator", "ExampleCollator",
           "ListDataSetIterator", "MultiDataSet", "MultipleEpochsIterator",
           "QueueDataSetIterator", "StreamingDataSetIterator"]
