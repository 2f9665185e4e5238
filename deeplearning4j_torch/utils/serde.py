"""JSON serde for config objects (port of ``deeplearning4j_tpu/utils/serde.py``).

The JAX package writes every config dataclass as a dict tagged with its
class name under ``"@class"`` (and activation and loss objects as
``{"@activation": name}`` / ``{"@loss": name}``); a model zip's
``configuration.json`` is that JSON. This module reads and writes the same
JSON with the port's own classes, registered here by the same names, so a
configuration saved by either package loads in the other.

An ``"@class"`` the port has no class for raises, naming it; so does a field
that the port's class does not carry, since the port would silently drop a
setting the JAX package honours. Fields the JSON leaves out take the port
class's defaults, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

_CLASSES: dict[str, type] = {}


def register_serializable(cls):
    """Class decorator: register a dataclass for tagged JSON round-tripping
    under its class name."""
    _CLASSES[cls.__name__] = cls
    return cls


def _ensure_registry() -> None:
    """Import every module that registers classes, so a process whose first
    call is ``load_model`` knows them all."""
    import deeplearning4j_torch.nn.conf.builders  # noqa: F401
    import deeplearning4j_torch.nn.conf.graph_conf  # noqa: F401
    import deeplearning4j_torch.nn.conf.inputs  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.attention  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.convolution  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.core  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.misc  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.moe  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.normalization  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.pooling  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.rbm  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.recurrent  # noqa: F401
    import deeplearning4j_torch.nn.conf.layers.variational  # noqa: F401
    import deeplearning4j_torch.nn.conf.preprocessors  # noqa: F401
    import deeplearning4j_torch.nn.transferlearning  # noqa: F401
    import deeplearning4j_torch.nn.updater  # noqa: F401
    import deeplearning4j_torch.nn.weights  # noqa: F401


def to_jsonable(obj: Any) -> Any:
    from deeplearning4j_torch.ops.activations import Activation
    from deeplearning4j_torch.ops.losses import LossFunction

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Activation):
        return {"@activation": obj.name}
    if isinstance(obj, LossFunction):
        return {"@loss": obj.name}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        d = {"@class": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = to_jsonable(getattr(obj, f.name))
        return d
    if hasattr(obj, "tolist"):  # numpy / torch scalars and arrays
        return obj.tolist()
    raise TypeError(f"Cannot serialise {type(obj)!r} to JSON")


def from_jsonable(d: Any) -> Any:
    from deeplearning4j_torch.ops.activations import get_activation
    from deeplearning4j_torch.ops.losses import get_loss

    if isinstance(d, list):
        return [from_jsonable(x) for x in d]
    if isinstance(d, dict):
        if "@activation" in d:
            return get_activation(d["@activation"])
        if "@loss" in d:
            return get_loss(d["@loss"])
        if "@class" in d:
            name = d["@class"]
            if name not in _CLASSES:
                _ensure_registry()
            if name not in _CLASSES:
                raise ValueError(f"Unknown config class '{name}' in JSON: "
                                 "the port has no class of that name")
            cls = _CLASSES[name]
            fields = {f.name for f in dataclasses.fields(cls)}
            unknown = sorted(set(d) - fields - {"@class"})
            if unknown:
                raise ValueError(f"config class '{name}' has fields "
                                 f"{unknown} that the port does not carry")
            return cls(**{k: from_jsonable(v) for k, v in d.items()
                          if k != "@class"})
        return {k: from_jsonable(v) for k, v in d.items()}
    return d


def to_json(obj: Any, indent=2) -> str:
    return json.dumps(to_jsonable(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_jsonable(json.loads(s))
