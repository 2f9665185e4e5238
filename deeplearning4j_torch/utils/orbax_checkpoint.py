"""Sharded training-state checkpoints (port of
``deeplearning4j_tpu/utils/orbax_checkpoint.py``), over
``torch.distributed.checkpoint`` (DCP).

The JAX module writes each shard from the device that owns it with orbax
and restores arrays with their shardings, so a sharded training job
resumes sharded; ``utils/model_serializer.py``'s zip gathers everything to
one host instead. The port keeps the module's name, its two functions and
its layout:

- ``<dir>/configuration.json``: the text of ``net.conf.to_json()``, written
  by rank 0 only (JAX's ``serde.from_json`` reads it);
- ``<dir>/state``: a DCP checkpoint of ``params``, ``updater_state``,
  ``state`` and the counters ``iteration`` and ``epoch``.

DCP knows plain tensors and ``DTensor``s, not the port's
``parallel/mesh.py::ShardedTensor`` leaves, so the state's keys are the
port's own layout: one key per distinct piece of a leaf,
``<tree>/<key>/<name>@<o0>,<o1>,...``, the piece's offset in the whole
leaf along each dim. Each process puts in the pieces it holds (a
``SpecTensor``'s model columns, a plain tensor whole at offset 0); DCP
writes a key that several ranks hold once, so a replicated leaf is written
once and a sharded one piece by piece by the processes that own them.

Restore walks a target's trees. With ``net`` given, its own current
placement is the target: each piece is read straight into a fresh tensor
on its entry (no gather), and a sharded leaf comes back a ``SpecTensor``
of the same sharding. Where the target's pieces are not the saved ones (a
different model-axis size) each target piece is assembled from the saved
pieces it overlaps. With ``net=None`` the net is rebuilt from
``configuration.json`` on ``device`` (CUDA unless the caller names
another) and every leaf is assembled whole.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

_TREES = ("params", "updater_state", "state")


def _key(path: str, offsets) -> str:
    return f"{path}@{','.join(str(int(o)) for o in offsets)}"


def _parse(key: str) -> tuple:
    path, _, off = key.rpartition("@")
    return path, tuple(int(o) for o in off.split(",") if o)


def _map(tree, path: str, fn):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and
    tuples (None stays None)."""
    if isinstance(tree, dict):
        return {k: _map(v, f"{path}/{k}", fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, f"{path}/{i}", fn)
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _spec_tensor():
    from deeplearning4j_torch.parallel.model_sharding import SpecTensor

    return SpecTensor


def _pieces(leaf) -> list:
    """``[(offsets, tensor)]``: the distinct pieces of ``leaf`` this process
    holds, each at its offset in the whole leaf."""
    from deeplearning4j_torch.parallel.mesh import ShardedTensor

    if isinstance(leaf, ShardedTensor):
        parts = leaf.parts()
        if leaf.dim is None:
            return [((0,) * parts[0].dim(), parts[0])]
        out, at = [], 0
        for p in parts:
            off = [0] * p.dim()
            off[leaf.dim] = at
            out.append((tuple(off), p))
            at += int(p.shape[leaf.dim])
        return out
    if torch.is_tensor(leaf):
        return [((0,) * leaf.dim(), leaf)]
    raise TypeError(f"a {type(leaf).__name__} leaf is not a tensor")


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` detached, in a storage of its own size (DCP writes a view's
    whole storage). A piece on a card other than the current one comes to
    the host here: DCP's writer copies card tensors to the host with
    ``non_blocking`` copies and then waits on the current card's stream
    only, so it could write such a piece before its copy lands."""
    t = t.detach()
    if t.is_cuda and t.device.index != torch.cuda.current_device():
        return t.to("cpu")
    if (not t.is_contiguous() or t.storage_offset() or
            t.untyped_storage().nbytes() != t.numel() * t.element_size()):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _state_dict(net) -> dict:
    sd: dict = {}

    def put(path, leaf):
        for off, t in _pieces(leaf):
            sd[_key(path, off)] = _own(t)
        return leaf

    for name in _TREES:
        _map(getattr(net, name), name, put)
    sd[_key("counters/iteration", ())] = torch.tensor(int(net.iteration))
    sd[_key("counters/epoch", ())] = torch.tensor(
        int(getattr(net, "epoch", 0)))
    return sd


def save_checkpoint(net, path: str) -> None:
    """Write a resumable checkpoint of ``net`` (MultiLayerNetwork or
    ComputationGraph) to directory ``path``. In a process group every rank
    calls it (DCP's save is collective); rank 0 writes the configuration."""
    import torch.distributed.checkpoint as dcp

    from deeplearning4j_torch.parallel import distributed

    path = os.path.abspath(path)
    if distributed.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "configuration.json"), "w",
                  encoding="utf-8") as f:
            f.write(net.conf.to_json())
    dcp.save(_state_dict(net), checkpoint_id=os.path.join(path, "state"),
             no_dist=not distributed.is_initialized())


class _Restore:
    """One restore's requests: each target region (a leaf path, offsets,
    shape, dtype, device) and the saved keys that fill it."""

    def __init__(self, metadata):
        self.saved: dict = {}
        for key, md in metadata.items():
            leaf, off = _parse(key)
            self.saved.setdefault(leaf, []).append(
                (off, tuple(md.size), key))
        self.direct: dict = {}      # saved key -> destination tensor
        self.host: dict = {}        # saved key -> host tensor (reassembly)
        self.assemble: list = []    # (destination, path, offsets)
        self.copies: list = []      # (SpecTensor, entry, source, device)

    def request(self, path, offsets, shape, dtype, device) -> torch.Tensor:
        if path not in self.saved:
            raise KeyError(f"the checkpoint holds no leaf {path!r}")
        dest = torch.empty(tuple(shape), dtype=dtype, device=device)
        key = _key(path, offsets)
        exact = [k for o, s, k in self.saved[path]
                 if k == key and s == tuple(shape)]
        if exact and key not in self.direct and key not in self.host:
            self.direct[key] = dest
            return dest
        for o, s, k in self.saved[path]:
            if _overlap(offsets, shape, o, s) is not None \
                    and k not in self.host and k not in self.direct:
                self.host[k] = torch.empty(s, dtype=dtype)
        self.assemble.append((dest, path, tuple(offsets)))
        return dest

    def finish(self) -> None:
        """After the read: assemble the regions read piece by piece, then
        copy each piece to the other data rows' entries."""
        for dest, path, offsets in self.assemble:
            filled = 0
            for o, s, k in self.saved[path]:
                box = _overlap(offsets, tuple(dest.shape), o, s)
                if box is None:
                    continue
                src = self.host[k] if k in self.host else self.direct[k]
                dst = dest
                for dim, (lo, hi) in enumerate(box):
                    src = src.narrow(dim, lo - o[dim], hi - lo)
                    dst = dst.narrow(dim, lo - offsets[dim], hi - lo)
                dst.copy_(src)
                filled += int(np.prod([hi - lo for lo, hi in box]))
            if filled != dest.numel():
                raise ValueError(f"the checkpoint's pieces of {path!r} "
                                 f"cover {filled} of {dest.numel()} "
                                 f"elements at {offsets}")
        for st, i, src, device in self.copies:
            st.pieces[i] = src.to(device, copy=True)


def _overlap(a_off, a_shape, b_off, b_shape):
    """The box two regions share, as ``[(lo, hi)]`` per dim, or None."""
    box = []
    for ao, as_, bo, bs in zip(a_off, a_shape, b_off, b_shape):
        lo, hi = max(ao, bo), min(ao + as_, bo + bs)
        if lo >= hi:
            return None
        box.append((lo, hi))
    return box


def _target(restore: _Restore, path: str, leaf):
    """The restored counterpart of ``leaf``: a fresh tensor on its device,
    or a ``SpecTensor`` of its sharding whose pieces are read onto their
    entries (and copied to the other data rows' entries of this
    process)."""
    SpecTensor = _spec_tensor()
    if isinstance(leaf, SpecTensor):
        loaded = [restore.request(path, off, t.shape, t.dtype, t.device)
                  for off, t in _pieces(leaf)]
        grid, mesh = leaf._grid, leaf.mesh
        entries = mesh.entries
        pieces = [None] * mesh.size
        later = []
        for d in range(grid.shape[0]):
            for e in range(grid.shape[1]):
                i = int(grid[d, e])
                if leaf.pieces[i] is None:
                    continue
                pieces[i] = loaded[e if leaf.dim is not None else 0]
                if d != leaf._row0:     # a copy once the read is done
                    later.append((i, pieces[i], entries[i]))
        st = SpecTensor(pieces, leaf.spec, mesh, grid)
        restore.copies.extend((st, i, src, dev) for i, src, dev in later)
        return st
    from deeplearning4j_torch.parallel.mesh import ShardedTensor

    if isinstance(leaf, ShardedTensor):
        raise TypeError(f"{path}: a {type(leaf).__name__} leaf has no "
                        "restore target; shard the net with "
                        "parallel/model_sharding.py")
    return restore.request(path, (0,) * leaf.dim(), leaf.shape,
                           leaf.dtype, leaf.device)


def load_checkpoint(path: str, net=None, *, device=None):
    """Restore from ``path``. With ``net`` given, its leaves' CURRENT
    placement is the target (a mesh-sharded net restores sharded, each
    process reading its own pieces onto their entries); without, the net
    is rebuilt from ``configuration.json`` on ``device`` (CUDA unless the
    caller names another) and restored unsharded. In a process group every
    rank calls it (DCP's load is collective)."""
    import torch.distributed.checkpoint as dcp

    from deeplearning4j_torch.parallel import distributed

    path = os.path.abspath(path)
    state_dir = os.path.join(path, "state")
    if net is None:
        from deeplearning4j_torch.utils import serde
        from deeplearning4j_torch.utils.model_serializer import net_from_conf

        with open(os.path.join(path, "configuration.json"),
                  encoding="utf-8") as f:
            net = net_from_conf(serde.from_json(f.read()), device=device)
    metadata = dcp.FileSystemReader(state_dir).read_metadata()
    restore = _Restore(metadata.state_dict_metadata)
    trees = {name: _map(getattr(net, name), name,
                        lambda p, leaf: _target(restore, p, leaf))
             for name in _TREES}
    counters = {n: restore.request(f"counters/{n}", (), (), torch.int64,
                                   "cpu") for n in ("iteration", "epoch")}
    dcp.load({**restore.direct, **restore.host}, checkpoint_id=state_dir,
             no_dist=not distributed.is_initialized())
    restore.finish()
    for name in _TREES:
        setattr(net, name, trees[name])
    net.iteration = int(counters["iteration"])
    if hasattr(net, "epoch"):
        net.epoch = int(counters["epoch"])
    return net
