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
  replica's device.

A mesh may name one device more than once: each entry is still a shard
with tensors of its own (the CPU tests build ``Mesh([cpu] * n, ...)``, the
counterpart of the JAX tests' eight XLA CPU devices). With
``devices=None``, ``model_mesh``, ``data_mesh`` and ``data_model_mesh``
count the distinct CUDA devices and raise ``MeshGeometryError`` where
JAX's raise; they never reuse one card quietly.
``shard_map_compat`` has no counterpart: each sharded body is written out
where it runs. Process groups (``torch.distributed``) are ROADMAP A11c.
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
    the tuple of names."""

    def __init__(self, devices, axis_names: Sequence[str]):
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

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list:
        """The entries in mesh order (row-major over the axes)."""
        return list(self.devices.flat)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat]})"


def local_devices() -> list:
    """Every CUDA device of this process (JAX's ``jax.devices()``)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pool(devices) -> list:
    return local_devices() if devices is None else [
        torch.device(d) for d in devices]


def model_mesh(tp: int, devices=None) -> Mesh:
    """1-D head-parallel (tensor-parallel) mesh over ``tp`` devices on the
    ``model`` axis, the mesh the sharded paged decode runs over. Validation
    is loud and typed (``MeshGeometryError``): a silent fallback to fewer
    cards would change the page budget the server admitted against."""
    devices = _pool(devices)
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
    return Mesh(devices[:tp], (MODEL_AXIS,))


def data_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``num_devices`` devices
    (default all)."""
    devices = _pool(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"Requested {num_devices} devices but only {len(devices)} "
                "present")
        devices = devices[:num_devices]
    if not devices:
        # no card and no devices named: the entry points' own refusal
        from deeplearning4j_torch import resolve_device
        resolve_device(None)
        raise MeshGeometryError("no device for a data mesh")
    return Mesh(devices, (DATA_AXIS,))


def data_model_mesh(data: int, model: int, devices=None) -> Mesh:
    """2-D mesh: ``data`` x ``model`` axes (DP x TP)."""
    devices = _pool(devices)
    n = data * model
    if n > len(devices):
        raise MeshGeometryError(
            f"Mesh {data}x{model} needs {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n], dtype=object).reshape(data, model),
                (DATA_AXIS, MODEL_AXIS))


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


def all_gather(shards, device, dim: int = 0) -> torch.Tensor:
    """Disjoint shards concatenated along ``dim`` in mesh order on
    ``device``: exact, no arithmetic. One shard comes back as it is (moved
    to ``device`` where it lives elsewhere)."""
    if len(shards) == 1:
        return shards[0].to(device)
    return torch.cat([s.to(device) for s in shards], dim=dim)


def pmean(trees: list, devices: list) -> list:
    """The mean of W replicas of one tree: summed in mesh order on the
    first replica's device, divided by W, and the same result written back
    to each replica's device (a replica on the first device shares the
    result's tensors). Integer leaves (step counters) are taken from the
    first replica, as every replica holds the same count."""
    W = len(trees)
    home = torch.device(devices[0])

    def mean(*leaves):
        first = leaves[0]
        if not torch.is_tensor(first) or not (first.is_floating_point()
                                               or first.is_complex()):
            return first
        acc = first.to(home)
        for t in leaves[1:]:
            acc = acc + t.to(home)
        return acc / W

    def zip_map(*ts):
        if isinstance(ts[0], dict):
            return {k: zip_map(*(t[k] for t in ts)) for k in ts[0]}
        if isinstance(ts[0], (list, tuple)):
            return type(ts[0])(zip_map(*parts) for parts in zip(*ts))
        if ts[0] is None:
            return None
        return mean(*ts)

    avg = zip_map(*trees)
    return [replicate(avg, d) for d in devices]


def data_devices(mesh: Mesh) -> list:
    """The devices a batch is split over: one per entry of the ``data``
    axis, in order (the first entry of any other axis; ``NamedSharding(
    mesh, P("data"))`` replicates over the others)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if DATA_AXIS not in mesh.axis_names:
        raise MeshGeometryError(
            f"a data-parallel mesh needs a {DATA_AXIS!r} axis, got axes "
            f"{mesh.axis_names}")
    ax = mesh.axis_names.index(DATA_AXIS)
    return list(np.moveaxis(mesh.devices, ax, 0).reshape(
        mesh.shape[DATA_AXIS], -1)[:, 0])


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
    P("data"))``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = data_devices(mesh)

    @property
    def device_set(self) -> set:
        return set(self.devices)

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
                and self.devices == other.devices)

    def __hash__(self):
        return hash(tuple(self.devices))

    def __repr__(self):
        return f"DataSharding({[str(d) for d in self.devices]})"


class ShardedArray:
    """An array placed by a :class:`DataSharding`: its pieces, one per
    device in mesh order. ``np.asarray`` gathers it to the host and
    :meth:`gather` onto one device."""

    def __init__(self, pieces: list, sharding: DataSharding):
        self.pieces = list(pieces)
        self.sharding = sharding

    @property
    def shape(self) -> tuple:
        first = self.pieces[0]
        return (sum(p.shape[0] for p in self.pieces),) + tuple(
            first.shape[1:])

    def gather(self, device) -> torch.Tensor:
        return all_gather(self.pieces, device)

    def __array__(self, dtype=None, copy=None):
        host = self.gather("cpu").numpy()
        return host if dtype is None else host.astype(dtype)
