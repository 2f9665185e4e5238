"""Input types (port of the ``InputType`` of
``deeplearning4j_tpu/nn/conf/inputs.py``): what a network input holds, so
the builders can infer each layer's ``n_in`` and insert the shape
preprocessors between layer kinds. Image arrays are NHWC and recurrent
arrays ``[batch, time, features]``, as in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from deeplearning4j_torch.utils.serde import register_serializable


@register_serializable
@dataclass(frozen=True)
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

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional", height=int(height),
                         width=int(width), channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType(kind="convolutional_flat", height=int(height),
                         width=int(width), channels=int(channels),
                         size=int(height) * int(width) * int(channels))

    def flat_size(self) -> int:
        """Features per example (per time step for recurrent inputs)."""
        if self.kind in ("feed_forward", "recurrent"):
            return self.size
        return self.height * self.width * self.channels

    def array_shape(self, batch: int = -1):
        """The array shape, batch first (NHWC, ``[B, T, F]``)."""
        if self.kind in ("feed_forward", "convolutional_flat"):
            return (batch, self.flat_size())
        if self.kind == "recurrent":
            t = self.timeseries_length if self.timeseries_length else -1
            return (batch, t, self.size)
        return (batch, self.height, self.width, self.channels)
