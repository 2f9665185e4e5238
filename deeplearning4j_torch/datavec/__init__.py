"""DataVec bridge: record readers -> DataSet minibatches (port of
``deeplearning4j_tpu/datavec``).

Reference: the external DataVec library's RecordReader SPI plus
deeplearning4j-core's bridge iterators
(datasets/datavec/RecordReaderDataSetIterator.java,
SequenceRecordReaderDataSetIterator.java, RecordReaderMultiDataSetIterator).
"""

from deeplearning4j_torch.datavec.records import (
    CollectionRecordReader,
    CollectionSequenceRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
)
from deeplearning4j_torch.datavec.iterators import (
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)

__all__ = [
    "CSVRecordReader", "CSVSequenceRecordReader", "CollectionRecordReader",
    "CollectionSequenceRecordReader", "ImageRecordReader",
    "RecordReaderDataSetIterator", "SequenceRecordReaderDataSetIterator",
    "RecordReaderMultiDataSetIterator",
]
