"""Cross-process streaming ingestion (the dl4j-streaming analog; port of
``deeplearning4j_tpu/streaming``).

Reference: dl4j-streaming's Kafka/Camel stack — routes
(streaming/routes/CamelKafkaRouteBuilder.java:16), publisher
(streaming/kafka/NDArrayPublisher.java), consumer
(streaming/kafka/NDArrayConsumer.java), serde
(serde/RecordSerializer.java). No Kafka broker exists in this
environment, so the broker itself is part of the framework: a small
TCP pub/sub topic broker with length-prefixed binary NDArray frames.
The pieces compose the same way the reference's do:

    producer process:  NDArrayPublisher -> (tcp) -> StreamingBroker
    trainer process:   StreamingBroker -> NDArrayConsumer ->
                       QueueDataSetIterator -> net.fit(...)

``NDArrayRoute`` is the Camel-route analog: one call wires a consumer
subscription into a queue iterator on a background thread.
"""

from deeplearning4j_torch.streaming.broker import StreamingBroker
from deeplearning4j_torch.streaming.client import (
    NDArrayConsumer,
    NDArrayPublisher,
    NDArrayRoute,
    StreamStalled,
)
from deeplearning4j_torch.streaming.serde import (
    dataset_from_bytes,
    dataset_to_bytes,
)

__all__ = [
    "StreamingBroker",
    "NDArrayPublisher",
    "NDArrayConsumer",
    "NDArrayRoute",
    "StreamStalled",
    "dataset_to_bytes",
    "dataset_from_bytes",
]
