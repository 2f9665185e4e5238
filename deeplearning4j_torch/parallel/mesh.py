"""Device meshes (port of ``deeplearning4j_tpu/parallel/mesh.py``).

A JAX ``Mesh`` is an array of one process's local devices with named axes;
one controller drives them and XLA inserts the collectives. The port keeps
that model: a :class:`Mesh` is an array of ``torch.device`` entries with
axis names, each shard's tensors live on its own entry's device, and one
process drives them all (DL4J's ``ParallelWrapper`` is likewise threads
over the devices of one JVM). The collectives are written out here:

- :func:`all_gather` concatenates disjoint shards in mesh order on the
  consumer's device (exact: no arithmetic);
- :func:`pmean` sums the replicas of a tree in mesh order on the first
  replica's device, divides by W and writes the same result back to every
  replica's device;
- :func:`psum` sums per-entry tensors in mesh order and hands the sum to
  every entry, :func:`all_to_all` splits one dim and concatenates
  another, :func:`ppermute` shifts tensors around a ring. Each is copies
  and concatenations plus the sum, so autograd flows through them.

A mesh may name one device more than once: each entry is still a shard
with tensors of its own (the CPU tests build ``Mesh([cpu] * n, ...)``, the
counterpart of the JAX tests' eight XLA CPU devices). With
``devices=None``, ``model_mesh``, ``data_mesh`` and ``data_model_mesh``
count the distinct CUDA devices and raise ``MeshGeometryError`` where
JAX's raise; they never reuse one card quietly.
``shard_map_compat`` has no counterpart: each sharded body is written out
where it runs.

Meshes that span processes: after ``parallel/distributed.py::initialize``
the builders with ``devices=None`` span every rank's local devices in rank
order, as ``jax.devices()`` lists every process's devices after
``jax.distributed.initialize``. Each entry knows its owning rank
(``Mesh.ranks``); only this process's entries hold tensors, a remote
entry's place in a list of pieces is None. The ``data`` axis may cross
processes; any other axis that would raises ``MeshGeometryError``
(ROADMAP A11d). :func:`pmean` and :func:`psum` over such a list sum this
process's entries in mesh order and then the ranks' sums through the group
(``all_reduce``); :func:`all_gather` takes each rank's pieces from it
(``broadcast``). :func:`make_array_from_process_local_data` places this
process's rows of a global batch. Consumers that run within one process
(``Mesh.flat``, :func:`data_devices`) refuse a mesh that spans processes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class MeshGeometryError(ValueError):
    """Typed, loud mesh-geometry failure: the requested tensor-parallel
    degree does not divide the device count, or (raised at pool-build time
    by the serving layer) the model's head count. A plain ``ValueError``
    subclass so ``except ValueError`` callers keep working, but catchable
    on its own by fleet factories that want to fall back to a smaller
    tp."""


class Mesh:
    """An array of ``torch.device`` entries with one name per axis.
    ``devices`` is a numpy object array shaped by the axes, ``shape`` maps
    each axis name to its size (JAX's ``Mesh.shape``), ``axis_names`` is
    the tuple of names. ``ranks`` (an int array of the same shape, or None
    for a mesh of this process alone) names each entry's owning rank."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise MeshGeometryError(
                f"mesh devices have {arr.ndim} axes, names {names}")
        if arr.size == 0:
            raise MeshGeometryError("a mesh needs at least one device")
        self.devices = arr
        self.axis_names = names
        self.ranks = None
        if ranks is not None:
            ranks = np.asarray(ranks, dtype=np.int64).reshape(arr.shape)
            for ax, name in enumerate(names):
                if name != DATA_AXIS and np.any(
                        ranks != ranks.take([0], axis=ax)):
                    raise MeshGeometryError(
                        f"the {name!r} axis would cross processes (entry "
                        f"ranks {ranks.tolist()}): only the {DATA_AXIS!r} "
                        "axis spans processes (ROADMAP A11d)")
            self.ranks = ranks

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len(set(self.ranks.flat)) > 1

    @property
    def flat(self) -> list:
        """The entries in mesh order (row-major over the axes), for
        consumers that run within one process."""
        self.require_one_process("this mesh consumer")
        return list(self.devices.flat)

    @property
    def entries(self) -> list:
        """Every entry's device in mesh order, remote entries included (a
        remote entry's device is the one its rank named)."""
        return list(self.devices.flat)

    def rank_of(self, i: int) -> int:
        """The owning rank of flat entry ``i``."""
        from deeplearning4j_torch.parallel import distributed

        return (distributed.process_index() if self.ranks is None
                else int(self.ranks.flat[i]))

    def is_local(self, i: int) -> bool:
        """Whether flat entry ``i`` belongs to this process."""
        from deeplearning4j_torch.parallel import distributed

        return (self.ranks is None
                or int(self.ranks.flat[i]) == distributed.process_index())

    def require_one_process(self, what: str) -> None:
        """Raise ``MeshGeometryError`` naming ``what`` where the mesh spans
        processes."""
        if self.spans_processes:
            raise MeshGeometryError(
                f"{what} runs over one process's devices; this mesh spans "
                f"ranks {sorted(set(self.ranks.ravel().tolist()))} (across "
                "processes: the data axis of parallel/model_sharding.py and "
                "the collectives; ROADMAP A11d)")

    def __repr__(self):
        ranks = ("" if self.ranks is None
                 else f", ranks={self.ranks.ravel().tolist()}")
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.entries]}{ranks})")


def local_devices() -> list:
    """Every CUDA device of this process (JAX's ``jax.local_devices()``
    on a host with cards)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pool(devices) -> tuple:
    """``(devices, ranks)``: the named devices of this process (ranks
    None), or with ``devices=None`` every rank's local devices in rank
    order after ``distributed.initialize`` (else this process's cards)."""
    if devices is not None:
        return [torch.device(d) for d in devices], None
    from deeplearning4j_torch.parallel import distributed

    layout = distributed.device_layout()
    if layout is None:
        return local_devices(), None
    return ([d for ds in layout for d in ds],
            [r for r, ds in enumerate(layout) for _ in ds])


def model_mesh(tp: int, devices=None) -> Mesh:
    """1-D head-parallel (tensor-parallel) mesh over ``tp`` devices on the
    ``model`` axis, the mesh the sharded paged decode runs over. Validation
    is loud and typed (``MeshGeometryError``): a silent fallback to fewer
    cards would change the page budget the server admitted against."""
    devices, ranks = _pool(devices)
    if tp < 1:
        raise MeshGeometryError(
            f"tensor-parallel degree must be >= 1, got {tp}")
    if tp > len(devices):
        raise MeshGeometryError(
            f"tensor-parallel degree {tp} exceeds the {len(devices)} "
            "available devices")
    if len(devices) % tp != 0:
        raise MeshGeometryError(
            f"device count {len(devices)} is not divisible by tp={tp}: "
            "replica groups would overlap — pass an explicit device "
            "subset instead")
    return Mesh(devices[:tp], (MODEL_AXIS,),
                None if ranks is None else ranks[:tp])


def data_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``num_devices`` devices
    (default all)."""
    devices, ranks = _pool(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"Requested {num_devices} devices but only {len(devices)} "
                "present")
        devices = devices[:num_devices]
        ranks = None if ranks is None else ranks[:num_devices]
    if not devices:
        # no card and no devices named: the entry points' own refusal
        from deeplearning4j_torch import resolve_device
        resolve_device(None)
        raise MeshGeometryError("no device for a data mesh")
    return Mesh(devices, (DATA_AXIS,), ranks)


def data_model_mesh(data: int, model: int, devices=None) -> Mesh:
    """2-D mesh: ``data`` x ``model`` axes (DP x TP). Over processes the
    rows are taken in rank order, as JAX's reshape of ``jax.devices()``:
    two processes of two cards each give ``data_model_mesh(2, 2)`` one
    process a data row."""
    devices, ranks = _pool(devices)
    n = data * model
    if n > len(devices):
        raise MeshGeometryError(
            f"Mesh {data}x{model} needs {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n], dtype=object).reshape(data, model),
                (DATA_AXIS, MODEL_AXIS),
                None if ranks is None else ranks[:n])


# ------------------------------------------------------------ collectives
def tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts, lists and tuples (None
    leaves stay None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def replicate(tree, device, copy: bool = False):
    """``tree``'s tensors on ``device``; ``copy`` gives the replica
    tensors of its own even where they already live there (replicas that
    train apart)."""
    device = torch.device(device)

    def put(t):
        if not torch.is_tensor(t):
            return t
        return t.to(device, copy=copy)

    return tree_map(put, tree)


def _remote(items) -> bool:
    """Whether a list of per-entry items leaves out other processes'
    entries (None in their places)."""
    return any(t is None for t in items)


def all_gather(shards, device, dim: int = 0, ranks=None) -> torch.Tensor:
    """Disjoint shards concatenated along ``dim`` in mesh order on
    ``device``: exact, no arithmetic. One shard comes back as it is (moved
    to ``device`` where it lives elsewhere). Where other processes' entries
    are None, ``ranks`` (each entry's owning rank) says whom to take them
    from: each rank broadcasts its pieces through the group (pieces of
    equal shape, as JAX's tiled all-gather)."""
    if _remote(shards):
        return all_gather(_gather_remote(shards, ranks, device), device,
                          dim=dim)
    if len(shards) == 1:
        return shards[0].to(device)
    return torch.cat([s.to(device) for s in shards], dim=dim)


def _gather_remote(shards, ranks, device) -> list:
    from deeplearning4j_torch.parallel import distributed

    if ranks is None or len(ranks) != len(shards):
        raise ValueError("an all-gather over entries of other processes "
                         "needs each entry's rank")
    me = distributed.process_index()
    like = next(t for t in shards if t is not None)
    out = list(shards)
    for r in sorted(set(int(r) for r in ranks)):
        idx = [i for i, ri in enumerate(ranks) if int(ri) == r]
        if r == me:
            buf = torch.stack([shards[i].to(device) for i in idx])
        else:
            buf = torch.empty((len(idx),) + tuple(like.shape),
                              dtype=like.dtype, device=device)
        buf = distributed.broadcast(buf, src=r)
        for j, i in enumerate(idx):
            out[i] = buf[j]
    return out


def pmean(trees: list, devices: list) -> list:
    """The mean of W replicas of one tree: summed in mesh order on the
    first replica's device, divided by W, and the same result written back
    to each replica's device (a replica on the first device shares the
    result's tensors). Integer leaves (step counters) are taken from the
    first replica, as every replica holds the same count. Where other
    processes' replicas are None, this process's are summed in mesh order,
    then the ranks' sums through the group (the same bits on every rank),
    and only this process's replicas get the mean (None elsewhere)."""
    W = len(trees)
    mine = [i for i, t in enumerate(trees) if t is not None]
    home = torch.device(devices[mine[0]])

    def floating(t):
        return torch.is_tensor(t) and (t.is_floating_point()
                                       or t.is_complex())

    def total(*leaves):
        if not floating(leaves[0]):
            return leaves[0]
        acc = leaves[0].to(home)
        for t in leaves[1:]:
            acc = acc + t.to(home)
        return acc

    def zip_map(*ts):
        if isinstance(ts[0], dict):
            return {k: zip_map(*(t[k] for t in ts)) for k in ts[0]}
        if isinstance(ts[0], (list, tuple)):
            return type(ts[0])(zip_map(*parts) for parts in zip(*ts))
        if ts[0] is None:
            return None
        return total(*ts)

    avg = zip_map(*(trees[i] for i in mine))
    if len(mine) < W:
        from deeplearning4j_torch.parallel import distributed

        leaves: list = []
        tree_map(lambda t: leaves.append(t) if floating(t) else None, avg)
        summed = iter(distributed.all_reduce_sum(leaves))
        avg = tree_map(lambda t: next(summed) if floating(t) else t, avg)
    avg = tree_map(lambda t: t / W if floating(t) else t, avg)
    return [None if trees[i] is None else replicate(avg, devices[i])
            for i in range(W)]


def psum(shards: list, devices=None) -> list:
    """The sum over one axis of per-entry tensors, the same result on
    every entry: summed in mesh order on the first entry's device, then
    copied back to each entry's device (``devices``, default each
    shard's own). Autograd flows through it: the backward of the sum
    hands every entry the sum of the cotangents, as JAX's psum
    transpose. Where other processes' entries are None, this process's
    are summed in mesh order and then the ranks' sums through the group
    (no autograd across it), and only this process's entries get the sum
    (None elsewhere)."""
    if _remote(shards):
        from deeplearning4j_torch.parallel import distributed

        mine = [i for i, t in enumerate(shards) if t is not None]
        devs = ([shards[i].device for i in mine] if devices is None
                else [devices[i] for i in mine])
        local = psum([shards[i] for i in mine], devs)[0]
        total = distributed.all_reduce_sum([local])[0]
        out: list = [None] * len(shards)
        for i, d in zip(mine, devs):
            out[i] = total if torch.device(d) == total.device else total.to(d)
        return out
    devices = [s.device for s in shards] if devices is None else devices
    home = shards[0].device
    acc = shards[0]
    for t in shards[1:]:
        acc = acc + t.to(home)
    return [acc if torch.device(d) == home else acc.to(d) for d in devices]


def _one_process(shards, what):
    if _remote(shards):
        raise MeshGeometryError(
            f"{what} over entries of other processes is not ported (ROADMAP "
            "A11d)")


def all_to_all(shards: list, split_dim: int, concat_dim: int) -> list:
    """JAX's tiled ``all_to_all`` over one axis of n entries: entry j
    splits its tensor into n pieces along ``split_dim`` and sends piece i
    to entry i, which concatenates the pieces it receives along
    ``concat_dim`` in sender order. A copy between devices and a
    concatenation, so autograd flows through it (the backward is the
    inverse all-to-all)."""
    _one_process(shards, "all_to_all")
    n = len(shards)
    pieces = [torch.chunk(s, n, dim=split_dim) for s in shards]
    for p, s in zip(pieces, shards):
        if len(p) != n or s.shape[split_dim] % n:
            raise ValueError(
                f"dim {split_dim} of shape {tuple(s.shape)} does not split "
                f"into {n} equal pieces")
    return [torch.cat([pieces[j][i].to(shards[i].device) for j in range(n)],
                      dim=concat_dim) for i in range(n)]


def ppermute(shards: list, shift: int = 1) -> list:
    """A ring shift over one axis: entry i's tensor moves to entry
    (i + shift) % n (JAX's ``ppermute`` with the ring permutation);
    autograd flows back around the ring."""
    _one_process(shards, "ppermute")
    n = len(shards)
    return [shards[(i - shift) % n].to(shards[i].device) for i in range(n)]


def data_entries(mesh: Mesh) -> tuple:
    """``(devices, ranks)`` of the entries a batch is split over: one per
    entry of the ``data`` axis, in order (the first entry of any other
    axis; ``NamedSharding(mesh, P("data"))`` replicates over the others),
    with each one's owning rank (None for a mesh of this process)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if DATA_AXIS not in mesh.axis_names:
        raise MeshGeometryError(
            f"a data-parallel mesh needs a {DATA_AXIS!r} axis, got axes "
            f"{mesh.axis_names}")
    ax = mesh.axis_names.index(DATA_AXIS)
    D = mesh.shape[DATA_AXIS]
    devices = list(np.moveaxis(mesh.devices, ax, 0).reshape(D, -1)[:, 0])
    ranks = (None if mesh.ranks is None else [
        int(r) for r in np.moveaxis(mesh.ranks, ax, 0).reshape(D, -1)[:, 0]])
    return devices, ranks


def data_devices(mesh: Mesh) -> list:
    """The devices a batch is split over, for consumers that run within
    one process (:func:`data_entries` for a mesh across processes)."""
    devices, _ = data_entries(mesh)
    mesh.require_one_process("a data-parallel consumer")
    return devices


def _version(t) -> int:
    try:
        return t._version
    except RuntimeError:            # an inference-mode tensor keeps none
        return -1


class Replicas:
    """Per-device copies of a net's params and state for data-parallel
    forwards: the net's own tensors on its device, a copy elsewhere, made
    again when the net's tensors have been replaced or updated."""

    def __init__(self, net):
        self.net = net
        self._cache: dict = {}

    def weights(self, device):
        net = self.net
        device = torch.device(device)
        if device == net.device:
            return net.params, net.state
        leaves = []
        tree_map(leaves.append, (net.params, net.state))
        sig = [(t, _version(t)) for t in leaves if torch.is_tensor(t)]
        hit = self._cache.get(device)
        if hit is None or len(hit[0]) != len(sig) or any(
                a is not b or va != vb
                for (a, va), (b, vb) in zip(hit[0], sig)):
            hit = (sig, replicate(net.params, device),
                   replicate(net.state, device))
            self._cache[device] = hit
        return hit[1], hit[2]


# ------------------------------------------------------- sharded placement
class DataSharding:
    """Axis 0 split into one equal piece per device of the mesh's ``data``
    axis, in order; the other axes whole (the port's ``NamedSharding(mesh,
    P("data"))``). Over a mesh that spans processes ``ranks`` names each
    piece's owning rank."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices, self.ranks = data_entries(mesh)

    @property
    def device_set(self) -> set:
        return set(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len(set(self.ranks)) > 1

    def local_indices(self) -> list:
        """The pieces this process holds, by index."""
        from deeplearning4j_torch.parallel import distributed

        if self.ranks is None:
            return list(range(len(self.devices)))
        me = distributed.process_index()
        return [i for i, r in enumerate(self.ranks) if r == me]

    def shard_shape(self, shape) -> tuple:
        """One piece's shape; ``ValueError`` when axis 0 does not split
        into equal pieces."""
        n = len(self.devices)
        if len(shape) == 0 or shape[0] % n:
            raise ValueError(f"axis 0 of shape {tuple(shape)} does not "
                             f"split into {n} equal pieces")
        return (shape[0] // n,) + tuple(shape[1:])

    def __eq__(self, other):
        return (isinstance(other, DataSharding)
                and self.devices == other.devices
                and self.ranks == other.ranks)

    def __hash__(self):
        return hash(tuple(self.devices))

    def __repr__(self):
        ranks = "" if self.ranks is None else f", ranks={self.ranks}"
        return f"DataSharding({[str(d) for d in self.devices]}{ranks})"


class ShardedTensor:
    """One logical tensor held as pieces on mesh devices: the distinct
    pieces (:meth:`parts`, in mesh order) concatenate along ``dim`` to the
    whole; with ``dim`` None each piece is the whole (replicated).
    :meth:`gather` assembles it on one device (the written-out
    all-gather), ``np.asarray`` on the host. Data-parallel batches
    (:class:`ShardedArray`), the dp x tp trainer's leaves
    (``model_sharding.py::SpecTensor``) and row-sharded embedding tables
    (``nlp/distributed.py::RowShardedTable``) are kinds of it. Over a mesh
    that spans processes the pieces of other processes' entries are None
    and ``global_shape`` gives the whole's shape."""

    def __init__(self, pieces: list, dim: Optional[int] = 0,
                 global_shape=None):
        self.pieces = list(pieces)
        self.dim = dim
        self._global_shape = (None if global_shape is None
                              else torch.Size(global_shape))

    def parts(self) -> list:
        """The distinct pieces, in order along ``dim``."""
        return self.pieces

    def local_pieces(self) -> list:
        """This process's pieces, in mesh order."""
        return [p for p in self.pieces if p is not None]

    @property
    def dtype(self) -> torch.dtype:
        return self.local_pieces()[0].dtype

    @property
    def device(self) -> torch.device:
        return self.local_pieces()[0].device

    @property
    def shape(self) -> torch.Size:
        if self._global_shape is not None:
            return self._global_shape
        parts = self.parts()
        shape = list(parts[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(int(p.shape[self.dim]) for p in parts)
        return torch.Size(shape)

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def piece_bytes(self) -> list:
        """The bytes of each piece, in mesh order (0 for another process's
        piece)."""
        return [0 if p is None else p.numel() * p.element_size()
                for p in self.pieces]

    def gather(self, device=None) -> torch.Tensor:
        device = self.device if device is None else device
        parts = self.parts()
        if _remote(parts):
            raise ValueError(
                f"{type(self).__name__} holds only this process's pieces; "
                "its whole needs the other ranks' (parallel.mesh.all_gather "
                "with the entries' ranks)")
        if self.dim is None:
            return parts[0].to(device)
        return all_gather(parts, device, dim=self.dim)

    def __array__(self, dtype=None, copy=None):
        host = self.gather("cpu").detach()
        if host.dtype in (torch.bfloat16, torch.float16):
            host = host.float()
        host = host.numpy()
        return host if dtype is None else host.astype(dtype)

    def __repr__(self):
        return (f"{type(self).__name__}(shape={tuple(self.shape)}, "
                f"pieces={len(self.pieces)})")


class ShardedArray(ShardedTensor):
    """An array placed by a :class:`DataSharding`: one piece per device of
    its ``data`` axis, in order along axis 0."""

    def __init__(self, pieces: list, sharding: DataSharding,
                 global_shape=None):
        super().__init__(pieces, 0, global_shape)
        self.sharding = sharding

    @property
    def process_local(self) -> bool:
        """Whether it holds only this process's rows of a batch whose other
        rows live in other processes."""
        return self.sharding.spans_processes


def make_array_from_process_local_data(sharding: DataSharding, local,
                                       global_shape=None) -> ShardedArray:
    """JAX's ``jax.make_array_from_process_local_data``: ``local`` (a
    numpy array or tensor) is this process's rows of the global batch, in
    order; each of this process's ``data`` entries gets its equal share on
    its device, and the other processes' entries stay None.
    ``global_shape`` defaults to the local rows times the processes'
    share."""
    if not isinstance(sharding, DataSharding):
        raise TypeError(f"sharding must be a parallel.mesh.DataSharding, "
                        f"got {type(sharding).__name__}")
    t = local if torch.is_tensor(local) else torch.from_numpy(
        np.ascontiguousarray(local))
    n = len(sharding.devices)
    mine = sharding.local_indices()
    if not mine:
        raise ValueError("this process holds no entry of the sharding")
    if global_shape is None:
        global_shape = (int(t.shape[0]) * n // len(mine),) + tuple(
            t.shape[1:])
    global_shape = tuple(int(g) for g in global_shape)
    per = sharding.shard_shape(global_shape)[0]
    if (int(t.shape[0]) != per * len(mine)
            or tuple(t.shape[1:]) != global_shape[1:]):
        raise ValueError(
            f"process-local rows of shape {tuple(t.shape)} are not this "
            f"process's {len(mine)} of {n} pieces of {global_shape}")
    pieces: list = [None] * n
    for j, i in enumerate(mine):
        pieces[i] = t[j * per:(j + 1) * per].to(sharding.devices[i])
    return ShardedArray(pieces, sharding, global_shape)
