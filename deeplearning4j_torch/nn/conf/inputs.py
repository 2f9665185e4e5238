"""Input types (port of the ``InputType`` of
``deeplearning4j_tpu/nn/conf/inputs.py``): what a network input holds, so
the builder can infer each layer's ``n_in``. The port's graphs take the
feed-forward and recurrent kinds; the convolutional kinds come with the
MultiLayerNetwork substrate (ROADMAP A7)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass
class InputType:
    kind: str = "feed_forward"  # feed_forward | recurrent | convolutional | convolutional_flat
    size: int = 0               # feed-forward / recurrent feature count
    timeseries_length: Optional[int] = None
    height: int = 0
    width: int = 0
    channels: int = 0

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="feed_forward", size=int(size))

    @staticmethod
    def recurrent(size: int,
                  timeseries_length: Optional[int] = None) -> "InputType":
        return InputType(kind="recurrent", size=int(size),
                         timeseries_length=timeseries_length)

    def flat_size(self) -> int:
        """Features per example (per time step for recurrent inputs)."""
        if self.kind in ("feed_forward", "recurrent"):
            return self.size
        return self.height * self.width * self.channels
