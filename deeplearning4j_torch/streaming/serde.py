"""DataSet <-> bytes for the streaming wire (port of
``deeplearning4j_tpu/streaming/serde.py``; reference: dl4j-streaming
serde/RecordSerializer.java + kafka NDArray message payloads). npz
container: self-describing shapes/dtypes, no pickle — a frame from an
untrusted producer can only decode into arrays. For the same arrays the
bytes equal the JAX package's, so either package's publisher feeds either
package's consumer."""

from __future__ import annotations

import io

import numpy as np
import torch

from deeplearning4j_torch.datasets.dataset import DataSet

_FIELDS = ("features", "labels", "features_mask", "labels_mask")


def _host(v) -> np.ndarray:
    """A numpy array of ``v``: a tensor (on the card too) is copied to the
    host explicitly."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def dataset_to_bytes(ds: DataSet) -> bytes:
    arrays = {}
    for name in _FIELDS:
        v = getattr(ds, name, None)
        if v is not None:
            arrays[name] = _host(v)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def dataset_from_bytes(payload: bytes) -> DataSet:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        kw = {name: z[name] for name in _FIELDS if name in z.files}
    return DataSet(kw.get("features"), kw.get("labels"),
                   features_mask=kw.get("features_mask"),
                   labels_mask=kw.get("labels_mask"))
