"""Process groups (port of ``deeplearning4j_tpu/parallel/distributed.py``).

The JAX module joins the multi-host runtime with one
``jax.distributed.initialize`` per host; after it every mesh of the
package spans all hosts' devices and the same step runs SPMD. The port's
counterpart is one ``torch.distributed`` process group: :func:`initialize`
joins it, after which the mesh builders of ``parallel/mesh.py`` with
``devices=None`` span every rank's local devices in rank order (each
entry knowing its owning rank, only this process's entries holding
tensors), and the data-parallel step of ``parallel/model_sharding.py``
sums its gradients over the ranks through the group.

- The backend is the caller's (``backend=``): NCCL by default when the
  process's device is a card, gloo on the CPU. It is never switched
  quietly: two ranks on one card must ask for gloo, since NCCL refuses
  them ("Duplicate GPU detected").
- A CUDA rank binds its card (``torch.cuda.set_device``) before the group
  exists, or NCCL would bind every rank to ``cuda:0``.
- The group gets a finite ``timeout`` (seconds), so a lost rank fails a
  collective in seconds rather than NCCL's ten minutes.
- The collectives the port sends through the group are ``all_reduce`` and
  ``broadcast`` only: the two that gloo takes on CUDA tensors as well as
  on host tensors, so one card shared by two gloo ranks runs the same
  path as NCCL over two cards. Host objects (the ranks' device lists) go
  through ``all_gather_object``.

With no arguments :func:`initialize` reads the environment ``torchrun``
sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), the counterpart of JAX's detection from the TPU metadata
server; ``cloud/provision.py`` launches every instance under ``torchrun``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "shutdown", "is_initialized", "global_device_count",
           "local_device_count", "process_index", "is_coordinator",
           "device_layout", "group_backend", "all_reduce_sum", "broadcast"]


class _Group:
    """What this process knows of the group it joined: its rank, the world
    size, the backend, its own devices and every rank's device list."""

    def __init__(self, rank: int, size: int, backend: str, devices: list,
                 layout: list):
        self.rank = rank
        self.size = size
        self.backend = backend
        self.devices = devices
        self.layout = layout


_GROUP: Optional[_Group] = None


def _env_int(name: str, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(
            f"initialize() needs {name.lower()} or the {name} environment "
            "variable that torchrun sets")
    return int(os.environ[name])


def _devices_for(device, process_id: int) -> list:
    """This process's devices: ``device`` (one or a list), or the card
    ``LOCAL_RANK`` (else ``process_id`` modulo the card count) names."""
    if device is None:
        from deeplearning4j_torch import resolve_device

        resolve_device(None)            # raises on a host without a card
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else process_id % torch.cuda.device_count())
        return [torch.device("cuda", index)]
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
    else:
        devices = [torch.device(device)]
    if not devices:
        raise ValueError("initialize() needs at least one local device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a process's devices are of one type, got "
                         f"{[str(d) for d in devices]}")
    if devices[0].type == "cuda":
        devices = [torch.device("cuda", 0 if d.index is None else d.index)
                   for d in devices]
    return devices


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               *, backend: Optional[str] = None, device=None,
               timeout: float = 60.0, **kwargs) -> None:
    """Join the process group (call once per process before any mesh
    work). ``num_processes=1`` is the single-process no-op. Otherwise
    ``torch.distributed.init_process_group`` at
    ``tcp://{coordinator_address}`` with ``world_size=num_processes`` and
    ``rank=process_id``; what is not given is read from torchrun's
    environment. ``store=`` (a ``torch.distributed.Store``) replaces the
    address, for a caller that holds the rendezvous itself; any other
    keyword goes to ``init_process_group``.

    ``device`` is this process's device or list of devices (a CUDA rank's
    default: the card ``LOCAL_RANK``, else ``process_id`` modulo the card
    count, names; a host without a card raises unless the caller names the
    CPU). ``backend`` defaults to NCCL on cards and gloo on the CPU."""
    global _GROUP
    if num_processes == 1:
        return
    if _GROUP is not None:
        raise RuntimeError("initialize() was already called in this "
                           "process; shutdown() first")
    world = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside a world of {world}")
    devices = _devices_for(device, rank)
    cuda = devices[0].type == "cuda"
    if cuda:
        # before the group exists: NCCL binds the current card
        torch.cuda.set_device(devices[0])
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl" and not cuda:
        raise ValueError("the NCCL backend needs CUDA devices; pass "
                         "backend='gloo' for the CPU")
    store = kwargs.pop("store", None)
    init = dict(backend=backend, world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=timeout), **kwargs)
    if store is not None:
        init["store"] = store
    else:
        if coordinator_address is None:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}"
                                   if "MASTER_ADDR" in os.environ else None)
        if coordinator_address is None:
            raise ValueError("initialize() needs coordinator_address, "
                             "store=, or torchrun's MASTER_ADDR and "
                             "MASTER_PORT")
        init["init_method"] = f"tcp://{coordinator_address}"
    dist.init_process_group(**init)
    try:
        layout = [None] * world
        dist.all_gather_object(layout, [str(d) for d in devices])
    except BaseException:
        dist.destroy_process_group()
        raise
    _GROUP = _Group(rank, world, backend, devices,
                    [[torch.device(d) for d in ds] for ds in layout])


def shutdown() -> None:
    """Leave the group (``destroy_process_group``); the queries answer for
    one process again. A no-op when no group was joined."""
    global _GROUP
    if _GROUP is None:
        return
    _GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return _GROUP is not None


def _one_process_count() -> int:
    """A process outside a group: its cards, or the host as one device
    (as a JAX CPU process counts one)."""
    return max(torch.cuda.device_count(), 1)


def device_layout() -> Optional[list]:
    """Every rank's device list, in rank order, or None outside a
    group."""
    return None if _GROUP is None else [list(ds) for ds in _GROUP.layout]


def global_device_count() -> int:
    if _GROUP is None:
        return _one_process_count()
    return sum(len(ds) for ds in _GROUP.layout)


def local_device_count() -> int:
    """The devices this process joined the group with."""
    return (len(_GROUP.devices) if _GROUP is not None
            else _one_process_count())


def process_index() -> int:
    return 0 if _GROUP is None else _GROUP.rank


def is_coordinator() -> bool:
    return process_index() == 0


def group_backend() -> Optional[str]:
    """The group's backend ("gloo", "nccl"), or None outside a group."""
    return None if _GROUP is None else _GROUP.backend


# ------------------------------------------------------------ collectives
def all_reduce_sum(tensors: list) -> list:
    """The sum over the ranks of each tensor, every rank getting the same
    bits: the tensors are packed by dtype into one buffer on this process's
    first device (the one the group bound; packing and the copies move no
    value), reduced with one ``all_reduce`` each, and handed back on their
    own devices in their own shapes. Outside a group, the inputs
    themselves."""
    if _GROUP is None or _GROUP.size == 1:
        return list(tensors)
    home = _GROUP.devices[0]
    out = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1).to(home) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        at = 0
        for i in idx:
            t = tensors[i]
            n = t.numel()
            out[i] = flat[at:at + n].view(t.shape).to(t.device)
            at += n
    return out


def broadcast(tensor: torch.Tensor, src: int) -> torch.Tensor:
    """``tensor`` as rank ``src`` holds it, on every rank (the receivers'
    ``tensor`` gives the shape and dtype), through this process's first
    device and back onto ``tensor``'s."""
    if _GROUP is None or _GROUP.size == 1:
        return tensor
    t = tensor.to(_GROUP.devices[0]).contiguous()
    dist.broadcast(t, src=src)
    return t.to(tensor.device)
