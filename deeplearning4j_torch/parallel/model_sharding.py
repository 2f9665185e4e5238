"""Tensor-parallel training of real networks over a (data, model) mesh
(port of ``deeplearning4j_tpu/parallel/model_sharding.py``).

The JAX module compiles the network's own jitted step against parameters
placed with per-layer ``NamedSharding``s and lets GSPMD partition it. The
port keeps JAX's spec rules (``network_param_specs``) and stores what they
say: every leaf as one piece per mesh entry, 1/m of a sharded leaf on each
model entry (the same piece on each data entry), a replicated leaf whole on
each; the updater state is stored like the params, the layer state is
replicated. The step is the net's own ``_loss`` (``net.fit``/``do_step``
run it through the net's step slot), with the layers' forwards run the way
GSPMD partitions them under those specs:

- Dense and convolution layers whose kernel and bias shard on their last
  axis, with an elementwise activation, are column-parallel: each model
  entry computes its output columns and an all-gather on features
  follows;
- ``SelfAttentionLayer`` runs its core on each entry's ``H/m`` heads (its
  Wq/Wk/Wv column shards are whole heads) through the flash kernels, K1
  forward and K3/K4 backward on CUDA tensors; the heads' outputs are
  gathered and Wo runs column-parallel;
- ``MixtureOfExpertsLayer`` computes each entry's E/m experts and sums
  their gated outputs over ``model`` (``psum``);
- any other layer gathers its leaves onto the row's device (a written-out
  all-gather, so gradients flow back to each piece) and runs unchanged.

The batch splits over the ``data`` entries: each data row runs the forward
and loss on its rows, and the gradients are summed over ``data`` in mesh
order, each row's weighted by its share of the global loss (1/rows, or
its share of the label mask). A net with batch normalization or a
stochastic layer (dropout), or a batch with an input mask, runs its whole
batch on the first data row, so batch statistics, dropout masks and the
mask's propagation stay those of the global batch. The
updater then steps each model column's pieces (every updater of the port
is elementwise); a layer with gradient normalization normalizes over its
gathered gradients.

A mesh whose ``data`` axis spans processes (built after
``parallel/distributed.py::initialize``; a data-only mesh shards nothing
and replicates every leaf) runs the same program on each process's own
data rows: only its entries hold pieces, its rows' gradients are summed in
mesh order and then over the ranks through the group (``all_reduce``: the
same bits on every rank, so the ranks' params stay bitwise equal), and so
are the loss and the label-mask weights. The batch is either the global
one (each process keeps its rows) or a process-local ``ShardedArray``
(``parallel/mesh.py::make_array_from_process_local_data``): ``do_step`` on
such an array shards an unsharded net over its mesh first, as JAX's step
returns params placed on the inputs' global mesh. What needs the global
batch in one place (batch statistics, dropout masks, an input mask, several
label masks) raises there (ROADMAP A11d).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch.nn.regularization import penalty_value
from deeplearning4j_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                DataSharding, Mesh,
                                                MeshGeometryError,
                                                ShardedArray, ShardedTensor,
                                                all_gather, psum, replicate)

__all__ = ["network_param_specs", "shard_network", "ShardedTrainer",
           "data_batch_sharding", "PartitionSpec", "ShardedTensor",
           "SpecTensor"]


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one mesh-axis name or None per dim
    (``P()`` replicates)."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _leaf_spec(arr, model_size: int, *, embedding: bool,
               expert: bool = False) -> P:
    shape = tuple(np.shape(arr))
    if len(shape) == 0:
        return P()
    if embedding and len(shape) == 2 and shape[0] % model_size == 0:
        return P(MODEL_AXIS, None)  # vocab-row sharding
    if expert and len(shape) >= 2 and shape[0] % model_size == 0:
        # stacked-expert tensors [E, ...]: each entry owns E/m experts
        return P(*([MODEL_AXIS] + [None] * (len(shape) - 1)))
    if shape[-1] % model_size == 0 and shape[-1] >= model_size:
        return P(*([None] * (len(shape) - 1) + [MODEL_AXIS]))
    return P()


def _layer_of(net, key: str):
    """The layer object behind a param-tree top key, for MLN (int index
    keys) and ComputationGraph (vertex-name keys with .layer), else None."""
    layers = getattr(net, "layers", None)
    if isinstance(layers, list) and key.isdigit() and int(key) < len(layers):
        return layers[int(key)]
    vertices = getattr(getattr(net, "conf", None), "vertices", None)
    if isinstance(vertices, dict) and key in vertices:
        return getattr(vertices[key], "layer", vertices[key])
    return None


def network_param_specs(net, model_size: int) -> dict:
    """PartitionSpec tree matching ``net.params`` under JAX's rules."""
    specs = {}
    for key, sub in net.params.items():
        layer = _layer_of(net, key)
        is_emb = type(layer).__name__ == "EmbeddingLayer"
        is_moe = type(layer).__name__ == "MixtureOfExpertsLayer"
        specs[key] = {
            name: _leaf_spec(arr, model_size, embedding=is_emb,
                             expert=is_moe and name != "Wg")
            for name, arr in sub.items()}
    return specs


def data_batch_sharding(mesh: Mesh, arr=None) -> DataSharding:
    """Batch (axis 0) split over ``data``, the rest whole. ``arr`` is
    accepted for JAX's signature; the placement does not depend on its
    rank."""
    return DataSharding(mesh)


# ------------------------------------------------------------ placement
def _model_dim(spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


class _Sharding:
    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other):
        if not isinstance(other, _Sharding) or self.spec != other.spec:
            return False
        a, b = self.mesh, other.mesh
        return a is b or (
            a.axis_names == b.axis_names and a.shape == b.shape
            and a.entries == b.entries
            and (a.ranks is None) == (b.ranks is None)
            and (a.ranks is None or bool((a.ranks == b.ranks).all())))

    def __hash__(self):
        return hash(tuple(self.spec))


class SpecTensor(ShardedTensor):
    """A leaf placed by its spec: one piece per mesh entry (flat mesh
    order); along its model-sharded dim entry (d, e) holds piece e, a
    replicated leaf is whole on every entry. ``sharding.spec`` is its
    spec."""

    def __init__(self, pieces: list, spec: P, mesh: Mesh, grid):
        super().__init__(pieces, _model_dim(spec))
        self.spec = P(*spec)
        self.mesh = mesh
        self._grid = grid            # [D, M] flat entry indices
        # the first data row this process holds (0 within one process)
        self._row0 = next(d for d in range(grid.shape[0])
                          if pieces[int(grid[d, 0])] is not None)

    @classmethod
    def place(cls, t: torch.Tensor, spec: P, mesh: Mesh, grid,
              copy: bool = False) -> "SpecTensor":
        """``t`` placed by ``spec``: a piece on each of this process's
        entries (other processes' entries hold None)."""
        flat = mesh.entries
        dim = _model_dim(spec)
        M = grid.shape[1]
        pieces = [None] * mesh.size
        for d in range(grid.shape[0]):
            for e in range(M):
                i = int(grid[d, e])
                if not mesh.is_local(i):
                    continue
                part = t if dim is None else torch.chunk(t, M, dim=dim)[e]
                pieces[i] = part.to(flat[i], copy=copy).contiguous()
        return cls(pieces, spec, mesh, grid)

    @property
    def sharding(self):
        return _Sharding(self.mesh, self.spec)

    def parts(self) -> list:
        """This process's first data row's pieces along the model-sharded
        dim."""
        if self.dim is None:
            return [self.column(0)]
        return [self.column(e) for e in range(self._grid.shape[1])]

    def column(self, e: int, d: Optional[int] = None) -> torch.Tensor:
        """The piece model entry ``e`` of data row ``d`` (default this
        process's first) holds."""
        return self.pieces[int(self._grid[self._row0 if d is None else d,
                                          e])]

    def __repr__(self):
        return f"SpecTensor(shape={tuple(self.shape)}, spec={self.spec})"


def _entry_grid(mesh: Mesh):
    """The [D, M] grid of flat entry indices: row d's model entries (M = 1
    on a data-only mesh)."""
    if DATA_AXIS not in mesh.shape or (MODEL_AXIS not in mesh.shape
                                       and len(mesh.axis_names) != 1):
        raise ValueError(
            f"mesh must have ({DATA_AXIS}, {MODEL_AXIS}) axes, got "
            f"{dict(mesh.shape)}")
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    if MODEL_AXIS not in mesh.shape:
        return idx.reshape(-1, 1)
    names = mesh.axis_names
    idx = np.moveaxis(idx, [names.index(DATA_AXIS),
                            names.index(MODEL_AXIS)], [0, 1])
    return idx.reshape(idx.shape[0], idx.shape[1], -1)[:, :, 0]


def _sharded_tree(sub) -> bool:
    """A ``{key: {name: SpecTensor}}`` tree (a placed param-shaped
    updater sub-tree)."""
    return isinstance(sub, dict) and any(
        isinstance(t, SpecTensor) for v in sub.values()
        if isinstance(v, dict) for t in v.values())


def _same_structure(sub, params) -> bool:
    if not isinstance(sub, dict) or sub.keys() != params.keys():
        return False
    return all(isinstance(sub[k], dict) and sub[k].keys() == params[k].keys()
               for k in params)


def shard_network(net, mesh: Mesh) -> dict:
    """Place ``net.params``/``updater_state`` on the mesh (params and
    updater state per-layer sharded, layer state replicated) and route the
    net's step (``do_step``, ``fit``) and ``output`` through the sharded
    program. Returns the param spec tree. A data-only mesh (``data_mesh``)
    replicates every leaf: data parallelism, across processes where the
    mesh spans them."""
    return _Program(net, mesh).specs


# ----------------------------------------------------- the row's leaves
class _RowLeaves(Mapping):
    """One layer's leaves as data row ``d`` sees them: reading a leaf
    gathers its pieces onto the row's device (once per forward, through
    autograd); ``tp_forward`` is set where the layer has a partitioned
    forward, which reads the pieces themselves."""

    def __init__(self, pieces: dict, specs: dict, devices: list, home,
                 rule=None):
        self._pieces = pieces        # name -> [piece on model entry e]
        self._specs = specs
        self.devices = devices
        self.home = home
        self._cache: dict = {}
        self.tp_forward = None if rule is None else (
            lambda layer, state, x, **kw: rule(self, layer, state, x, **kw))

    def __getitem__(self, name):
        if name not in self._cache:
            pieces = self._pieces[name]
            dim = _model_dim(self._specs[name])
            self._cache[name] = (pieces[0].to(self.home) if dim is None
                                 else all_gather(pieces, self.home, dim=dim))
        return self._cache[name]

    def __iter__(self):
        return iter(self._pieces)

    def __len__(self):
        return len(self._pieces)

    def local(self, e: int) -> dict:
        """Model entry ``e``'s own leaves (a replicated leaf whole)."""
        return {n: (p[e] if _model_dim(self._specs[n]) is not None
                    else p[0].to(self.devices[e]))
                for n, p in self._pieces.items()}


def _column_forward(tp, layer, state, x, *, mask=None, train=False,
                    rng=None):
    """Column-parallel dense or convolution: each entry's output columns
    (an elementwise activation commutes with the split), then one
    all-gather on the feature dim."""
    x = layer.apply_input_dropout(x, train=train, rng=rng)
    outs = [layer.act()(layer.preactivate(tp.local(e), x.to(dev)))
            for e, dev in enumerate(tp.devices)]
    return all_gather(outs, x.device, dim=-1), state


def _heads_forward(tp, layer, state, x, *, mask=None, train=False,
                   rng=None):
    """Self-attention on each entry's H/m heads: the entry's Wq/Wk/Wv
    column shards project its heads, the core runs through the layer's
    own attend (K1 forward, K3/K4 backward on CUDA tensors), the heads'
    outputs are gathered on features and Wo runs column-parallel."""
    if "kpages" in state or "kcache" in state:
        raise ValueError("the sharded forward takes no serving carry")
    x = layer.apply_input_dropout(x, train=train, rng=rng)
    home = x.device
    M = len(tp.devices)
    B, T, _ = x.shape
    H = layer.n_heads // M

    def heads(t):
        return t.reshape(B, T, H, -1).permute(0, 2, 1, 3)

    merged = []
    for e, dev in enumerate(tp.devices):
        p = tp.local(e)
        xe = x.to(dev)
        me = None if mask is None else mask.to(dev)
        o = layer._attend(heads(layer._proj(p, xe, "Wq")),
                          heads(layer._proj(p, xe, "Wk")),
                          heads(layer._proj(p, xe, "Wv")), me)
        merged.append(o.permute(0, 2, 1, 3).reshape(B, T, -1))
    o = all_gather(merged, home, dim=-1)
    outs = []
    for e, dev in enumerate(tp.devices):
        p = tp.local(e)
        outs.append(layer._proj(p, o.to(dev), "Wo") + p["b"])
    out = all_gather(outs, home, dim=-1)
    if mask is not None:
        out = out * mask.to(out.dtype)[:, :, None]
    return layer.act()(out), state


def _experts_forward(tp, layer, state, x, *, mask=None, train=False,
                     rng=None):
    """Expert parallelism: the gate over every expert on the row's device
    (``Wg`` gathered), each entry's E/m experts on its own device, their
    gated outputs summed over ``model`` in mesh order."""
    from deeplearning4j_torch.ops.activations import get_activation

    x = layer.apply_input_dropout(x, train=train, rng=rng)
    gates = layer._gate(tp, x)
    act = get_activation(layer.activation)
    M = len(tp.devices)
    E = gates.shape[-1] // M
    parts = []
    for e, dev in enumerate(tp.devices):
        p = tp.local(e)
        xe = x.to(dev)
        h = act(torch.einsum("...d,edh->...eh", xe, p["W1"]) + p["b1"])
        y = torch.einsum("...eh,eho->...eo", h, p["W2"]) + p["b2"]
        g = gates[..., e * E:(e + 1) * E].to(dev)
        parts.append(torch.einsum("...e,...eo->...o", g, y))
    return psum(parts, [x.device] * M)[0], state


_NOT_ELEMENTWISE = ("softmax", "logsoftmax", "log_softmax")


def _rule_for(layer, specs: dict, M: int):
    """The partitioned forward a layer takes under ``specs``, or None
    (its leaves are gathered)."""
    if layer is None or M == 1 or any(n.endswith("_scale") for n in specs):
        return None
    kind = type(layer).__name__

    def sharded_last(*names):
        return all(n in specs and len(specs[n]) >= 1
                   and specs[n][-1] == MODEL_AXIS for n in names)

    if kind in ("DenseLayer", "ConvolutionLayer"):
        names = [n for n in ("W", "b") if n in specs]
        act = str(getattr(layer, "activation", "")).lower()
        if ("W" in names and sharded_last(*names) and set(specs) <= {"W", "b"}
                and act not in _NOT_ELEMENTWISE):
            return _column_forward
    if kind == "SelfAttentionLayer":
        if (sharded_last("Wq", "Wk", "Wv", "Wo", "b")
                and layer.n_heads % M == 0):
            return _heads_forward
    if kind == "MixtureOfExpertsLayer":
        if all(specs.get(n, P())[:1] == (MODEL_AXIS,)
               for n in ("W1", "b1", "W2", "b2")):
            return _experts_forward
    return None


def _process_local(a) -> bool:
    return isinstance(a, ShardedArray) and a.process_local


def _row_pieces(t, D: int):
    """A ``ShardedArray``'s pieces as the D rows' batch pieces (None for
    the rows of other processes)."""
    if t is None:
        return [None] * D
    if isinstance(t, (list, tuple)):
        cols = [_row_pieces(a, D) for a in t]
        return [None if cols[0][d] is None else [c[d] for c in cols]
                for d in range(D)]
    return list(t.pieces)


def _split_rows(t, D: int):
    if t is None:
        return [None] * D
    if isinstance(t, (list, tuple)):
        cols = [_split_rows(a, D) for a in t]
        return [[c[d] for c in cols] for d in range(D)]
    return list(torch.chunk(t, D, dim=0))


def _to(t, device):
    if t is None:
        return None
    if isinstance(t, (list, tuple)):
        return [_to(a, device) for a in t]
    return t.to(device)


# ---------------------------------------------------------- the program
class _Program:
    """The sharded params, updater state and step of one net over one
    mesh. Installs itself on the net: ``net.params`` and
    ``net.updater_state`` hold :class:`SpecTensor` leaves, and the
    net's step slot, ``output`` and ``params_flat`` run through here."""

    def __init__(self, net, mesh: Mesh):
        if getattr(net, "_sharded", None) is not None:
            raise ValueError("the net is already sharded")
        self.net = net
        self.mesh = mesh
        self.grid = _entry_grid(mesh)
        self.D, self.M = self.grid.shape
        flat = mesh.entries
        self.row_devices = [[flat[int(i)] for i in row] for row in self.grid]
        # the data rows this process runs (every row within one process)
        # and each row's rank
        self.cross = mesh.spans_processes
        self.rows = [d for d in range(self.D)
                     if mesh.is_local(int(self.grid[d, 0]))]
        self.row_ranks = [mesh.rank_of(int(self.grid[d, 0]))
                          for d in range(self.D)]
        if not self.rows:
            raise MeshGeometryError("this process holds no entry of the "
                                    "mesh")
        self.specs = (network_param_specs(net, self.M)
                      if MODEL_AXIS in mesh.shape else
                      {k: {n: P() for n in sub}
                       for k, sub in net.params.items()})
        self.owners = net._param_owners()
        self.rules = {k: _rule_for(_layer_of(net, k), self.specs[k], self.M)
                      for k in self.specs}
        params = net.params
        net.params = self._place(params)
        net.updater_state = {
            k: (self._place(sub, copy=True)
                if _same_structure(sub, params) else sub)
            for k, sub in net.updater_state.items()}
        self._collapse = self._needs_one_row()
        if self.cross and self._collapse:
            raise MeshGeometryError(
                "a net with batch statistics or a stochastic layer needs "
                "its global batch on one data row, which a data axis across "
                "processes does not hold (ROADMAP A11d)")
        self._state_cache: dict = {}
        self._net_batch = net._batch
        net._sharded = self
        net._get_step = self._get_step
        net._batch = self._batch
        net.output = self.output
        net.params_flat = self.params_flat

    def _place(self, tree, copy=False):
        return {k: {n: SpecTensor.place(t, self.specs[k][n], self.mesh,
                                           self.grid, copy=copy)
                    for n, t in sub.items()} for k, sub in tree.items()}

    def _needs_one_row(self) -> bool:
        """Batch statistics and dropout see the global batch only when it
        is not split over rows."""
        net = self.net
        for owner in self.owners.values():
            if type(owner).__name__ in ("BatchNormalization",):
                return True
        return net._step_rng(0) is not None

    # ---------------------------------------------------- row forwards
    def _row_params(self, params, d: int, leaves=None):
        """Row ``d``'s param tree; with ``leaves`` (a list), each piece it
        reads is a fresh leaf that requires grad, appended there as
        (key, name, e, tensor)."""
        devs = self.row_devices[d]
        home = devs[0]
        out = {}
        for key, sub in params.items():
            pieces, specs = {}, {}
            for name, st in sub.items():
                spec = st.spec
                cols = ([st.column(e, d) for e in range(self.M)]
                        if _model_dim(spec) is not None else [st.column(0, d)])
                if leaves is not None:
                    cols = [c.detach().requires_grad_(True) for c in cols]
                    leaves.extend((key, name, e, c)
                                  for e, c in enumerate(cols))
                pieces[name] = cols
                specs[name] = spec
            out[key] = _RowLeaves(pieces, specs, devs, home,
                                  self.rules.get(key))
        return out

    def _state_on(self, state, device):
        hit = self._state_cache.get(device)
        if hit is None or hit[0] is not state:
            hit = (state, replicate(state, device))
            self._state_cache[device] = hit
        return hit[1]

    def _rows(self, im, lm) -> int:
        """Data rows a batch splits over: one where the split would change
        the math (batch statistics, dropout, an input mask's propagation,
        several label masks), else the data axis."""
        if self._collapse or im is not None or (
                isinstance(lm, (list, tuple)) and len(lm) != 1):
            return 1
        return self.D

    def _batch(self, x, y, im, lm):
        """The net's ``_batch``, except that process-local
        ``ShardedArray``s keep their pieces (in the param dtype, masks in
        f32) for the rows they belong to."""
        if not _process_local(x):
            return self._net_batch(x, y, im, lm)
        dtype = getattr(torch, self.net.conf.dtype)

        def keep(a, dt):
            if a is None:
                return None
            if isinstance(a, (list, tuple)):
                return [keep(b, dt) for b in a]
            if not _process_local(a):
                raise ValueError("process-local features need process-local "
                                 "labels and masks (make_array_from_process_"
                                 "local_data)")
            if a.sharding != DataSharding(self.mesh):
                raise ValueError(f"a batch placed by {a.sharding} does not "
                                 f"split over this net's mesh {self.mesh}")
            return ShardedArray([None if p is None else p.to(dtype=dt)
                                 for p in a.pieces], a.sharding, a.shape)

        return (keep(x, dtype), keep(y, dtype), keep(im, torch.float32),
                keep(lm, torch.float32))

    def _split_batch(self, x, y, im, lm):
        """``(R, xs, ys, ims, lms)``: the batch in R row pieces (None for
        the rows of other processes)."""
        R = self._rows(im, lm)
        if self.cross and R != self.D:
            raise MeshGeometryError(
                "an input mask or several label masks need the global batch "
                "on one data row, which a data axis across processes does "
                "not hold (ROADMAP A11d)")
        first = x[0] if isinstance(x, (list, tuple)) else x
        B = first.shape[0]
        if B % R:
            raise ValueError(f"batch size {B} not divisible by data-axis "
                             f"size {R}")
        if isinstance(first, ShardedArray):
            return R, _row_pieces(x, R), _row_pieces(y, R), \
                _row_pieces(im, R), _row_pieces(lm, R)
        return R, _split_rows(x, R), _split_rows(y, R), \
            _split_rows(im, R), _split_rows(lm, R)

    # ------------------------------------------------------------ step
    def _get_step(self, key):
        """The net's step slot: the sharded core, and the fused K-step
        block over it."""
        from deeplearning4j_torch.optimize.fused_fit import build_fused_step

        cache = self.net._step_cache
        if key not in cache:
            core = self._core(key[-1])
            cache[key] = (build_fused_step(self.net, key[-1], core)
                          if key[0] == "fused" else core)
        return cache[key]

    def _core(self, guarded):
        from deeplearning4j_torch.nn.gradient_normalization import (
            apply_gradient_normalization)
        from deeplearning4j_torch.nn.regularization import (
            add_regularization_grads)
        from deeplearning4j_torch.optimize.fused_fit import _center_heads
        from deeplearning4j_torch.optimize.health import all_finite

        net = self.net
        if _center_heads(net):
            raise ValueError("a center-loss head does not shard: its "
                             "centers move outside the gradient")
        updater = net.conf.updater
        lr_mults = net._lr_mult_tree()
        normalized = {k: o for k, o in self.owners.items()
                      if getattr(o, "gradient_normalization", None)
                      not in (None, "none")}

        def core(params, opt_state, state, rng, iteration, x, y, im, lm,
                 carry):
            if carry is not None:
                raise ValueError("the sharded step takes no carry")
            R, xs, ys, ims, lms = self._split_batch(x, y, im, lm)
            rows = self.rows if self.cross else list(range(R))
            leaves: list = []
            losses = []
            new_states = None
            home0 = self.row_devices[rows[0]][0]
            with torch.enable_grad():
                for d in rows:
                    home = self.row_devices[d][0]
                    rp = self._row_params(params, d, leaves)
                    if d == rows[0]:
                        rp0 = rp
                    loss, (ns, _, _) = net._loss(
                        rp, self._state_on(state, home), _to(xs[d], home),
                        _to(ys[d], home), _to(ims[d], home),
                        _to(lms[d], home), train=True, rng=rng, carry=None)
                    losses.append(loss.to(home0))
                    if d == rows[0]:
                        new_states = ns
                w = self._row_weights(lms, R, home0, rows)
                gs = torch.autograd.grad(
                    sum(l_ * w_ for l_, w_ in zip(losses, w)),
                    [t for *_, t in leaves], allow_unused=True)
            with torch.no_grad():
                losses = [l_.detach() for l_ in losses]
                if lms[rows[0]] is None:   # rows of equal size: a plain mean
                    loss = self._over_ranks(
                        psum(losses, [home0] * len(rows))[0]) / R
                else:   # the label-mask-weighted mean; the penalty once
                    pen = penalty_value(net, rp0)
                    loss = self._over_ranks(
                        psum([(l_ - pen) * w_ for l_, w_ in
                              zip(losses, w)], [home0] * len(rows))[0]) + pen
                cols = self._column_grads(leaves, gs)
                p_cols = [self._column_tree(params, e)
                          for e in range(self.M)]
                cols = [add_regularization_grads(net, p_cols[e], cols[e])
                        for e in range(self.M)]
                if guarded:
                    keep = all(bool(all_finite(
                        loss.to(self.row_devices[0][e]), cols[e]))
                        for e in range(self.M))
                if normalized:
                    cols = self._normalize(normalized, cols,
                                           apply_gradient_normalization)
                new_p, new_o = [], []
                for e in range(self.M):
                    o_col = self._column_opt(opt_state, e)
                    if lr_mults is not None:
                        steps, o2 = updater.step(cols[e], o_col, iteration,
                                                 lr_mults)
                    else:
                        steps, o2 = updater.step(cols[e], o_col, iteration)
                    new_p.append({k: {n: t - steps[k][n]
                                      for n, t in sub.items()}
                                  for k, sub in p_cols[e].items()})
                    new_o.append(o2)
                params2 = self._assemble(new_p, params)
                opt2 = self._assemble_opt(new_o, opt_state)
                new_states = replicate(new_states, home0)
                if guarded:
                    skip = torch.full((), 0.0 if keep else 1.0,
                                      device=loss.device)
                    if not keep:
                        return params, opt_state, state, None, loss, skip
                    return params2, opt2, new_states, None, loss, skip
            return params2, opt2, new_states, None, loss

        return core

    def _over_ranks(self, t):
        """``t`` summed over the ranks where the data axis spans
        processes, else ``t``."""
        if not self.cross:
            return t
        from deeplearning4j_torch.parallel import distributed

        return distributed.all_reduce_sum([t])[0]

    def _row_weights(self, lms, R: int, device, rows) -> list:
        """Each of ``rows``' share of the global loss: 1/R for rows of
        equal size, else its label-mask total over the batch's (each
        clamped at 1 as the loss's mean clamps it; the batch's summed over
        the ranks across processes), so the rows' masked means sum to the
        global masked mean. No host sync."""
        if R == 1 or lms[rows[0]] is None:
            return [1.0 / R] * len(rows)

        def total(m):
            m = m[0] if isinstance(m, (list, tuple)) else m
            return m.to(device, torch.float32).sum().clamp_min(1.0)

        whole = self._over_ranks(sum(total(lms[d]) for d in rows))
        return [total(lms[d]) / whole for d in rows]

    def _column_grads(self, leaves, gs) -> list:
        """Per model column, the gradient tree summed over the data rows
        (each row's loss weighted by its share) in mesh order on the
        column's first entry (a replicated leaf's gradient is its row
        copy's, the same for every column)."""
        acc: dict = {}
        for (key, name, e, t), g in zip(leaves, gs):
            if g is None:
                g = torch.zeros_like(t)
            acc.setdefault((key, name, e), []).append(g)
        cols = [dict() for _ in range(self.M)]
        for key, sub in self.net.params.items():
            for name, st in sub.items():
                sharded = _model_dim(st.spec) is not None
                for e in range(self.M):
                    parts = acc[(key, name, e if sharded else 0)]
                    dev = st.column(e).device
                    g = psum(parts, [dev] * len(parts))[0]
                    cols[e].setdefault(key, {})[name] = g
        if self.cross:
            self._sum_over_ranks(cols)
        return cols

    def _sum_over_ranks(self, cols: list) -> None:
        """The columns' gradients summed over the ranks (one all-reduce of
        every distinct piece; a replicated leaf's sum copied to the other
        columns' devices)."""
        from deeplearning4j_torch.parallel import distributed

        where, flat = [], []
        for key, sub in self.net.params.items():
            for name, st in sub.items():
                sharded = _model_dim(st.spec) is not None
                for e in range(self.M if sharded else 1):
                    where.append((e, key, name))
                    flat.append(cols[e][key][name])
        for (e, key, name), g in zip(where,
                                     distributed.all_reduce_sum(flat)):
            cols[e][key][name] = g
        for key, sub in self.net.params.items():
            for name, st in sub.items():
                if _model_dim(st.spec) is None:
                    for e in range(1, self.M):
                        cols[e][key][name] = cols[0][key][name].to(
                            st.column(e).device)

    def _column_tree(self, params, e: int) -> dict:
        return {k: {n: st.column(e) for n, st in sub.items()}
                for k, sub in params.items()}

    def _column_opt(self, opt_state, e: int) -> dict:
        """Column ``e``'s updater state: its pieces of each param-shaped
        sub-tree, any other entry (a step counter) as it is."""
        return {k: self._column_tree(sub, e) if _sharded_tree(sub) else sub
                for k, sub in opt_state.items()}

    def _assemble(self, cols: list, like) -> dict:
        """SpecTensors from the columns' new pieces: column e's piece
        on this process's first row's entry e, a copy on every other data
        row's entry of this process."""
        out = {}
        flat = self.mesh.entries
        for k, sub in like.items():
            out[k] = {}
            for n, st in sub.items():
                pieces = [None] * self.mesh.size
                for d in self.rows:
                    for e in range(self.M):
                        i = int(self.grid[d, e])
                        t = cols[e][k][n]
                        pieces[i] = t if d == self.rows[0] else t.to(flat[i])
                out[k][n] = SpecTensor(pieces, st.spec, self.mesh,
                                       self.grid)
        return out

    def _assemble_opt(self, cols: list, like) -> dict:
        return {k: (self._assemble([c[k] for c in cols], sub)
                    if _sharded_tree(sub) else cols[0][k])
                for k, sub in like.items()}

    def _normalize(self, normalized: dict, cols: list, apply) -> list:
        """Gradient normalization of each such layer over its whole
        gradient: gathered from the columns, normalized, split again."""
        for key, layer in normalized.items():
            sub = self.net.params[key]
            full = {}
            for n, st in sub.items():
                dim = _model_dim(st.spec)
                parts = [c[key][n] for c in cols]
                full[n] = parts[0] if dim is None else all_gather(
                    parts, parts[0].device, dim=dim)
            done = apply({key: layer}, {key: full})[key]
            for n, st in sub.items():
                dim = _model_dim(st.spec)
                for e, c in enumerate(cols):
                    g = done[n] if dim is None else torch.chunk(
                        done[n], self.M, dim=dim)[e]
                    c[key][n] = g.to(st.column(e).device)
        return cols

    # ----------------------------------------------------------- output
    def output(self, x, train: bool = False, mask=None):
        """Sharded inference: the batch over ``data``, params stay
        tensor-sharded; rows in order on the first entry's device."""
        net = self.net
        dtype = getattr(torch, net.conf.dtype)
        if isinstance(x, (list, tuple)):
            x = [net._as_tensor(a, dtype) for a in x]
        else:
            x = net._as_tensor(x, dtype)
        mask = None if mask is None else _to(
            torch.as_tensor(np.asarray(mask), dtype=torch.float32),
            net.device)
        R = self._rows(mask, None)
        if self.cross and R != self.D:
            raise MeshGeometryError(
                "an input mask needs the global batch on one data row, "
                "which a data axis across processes does not hold (ROADMAP "
                "A11d)")
        B = (x[0] if isinstance(x, (list, tuple)) else x).shape[0]
        if B % R:
            raise ValueError(f"batch size {B} not divisible by data-axis "
                             f"size {R}")
        outs = []
        xs, ms = _split_rows(x, R), _split_rows(mask, R)
        with torch.no_grad():
            for d in range(R):
                if self.cross and d not in self.rows:
                    outs.append(None)
                    continue
                xd, md = xs[d], ms[d]
                home = self.row_devices[d][0]
                rp = self._row_params(net.params, d)
                xin = _to(xd, home)
                if isinstance(xin, list):
                    res = net._forward(rp, self._state_on(net.state, home),
                                       xin, _to(md, home), train=train)[0]
                    outs.append(res[0] if len(res) == 1 else res)
                else:
                    outs.append(net._forward(
                        rp, self._state_on(net.state, home), xin,
                        _to(md, home), train=train)[0])
        ranks = self.row_ranks if self.cross else None
        mine = outs[self.rows[0]]
        if isinstance(mine, list):
            return [all_gather([None if o is None else o[j] for o in outs],
                               net.device, ranks=ranks)
                    for j in range(len(mine))]
        return all_gather(outs, net.device, ranks=ranks)

    def params_flat(self) -> np.ndarray:
        from deeplearning4j_torch.utils.pytree import flatten_params

        full = {k: {n: st.gather(self.net.device) for n, st in sub.items()}
                for k, sub in self.net.params.items()}
        return flatten_params(full, self.owners)

    def entry_bytes(self) -> list:
        """Param plus updater-state bytes each mesh entry holds."""
        out = [0] * self.mesh.size
        trees = [self.net.params] + [
            s for s in self.net.updater_state.values() if isinstance(s, dict)]
        for tree in trees:
            for sub in tree.values():
                if not isinstance(sub, dict):
                    continue
                for st in sub.values():
                    if isinstance(st, SpecTensor):
                        for i, b in enumerate(st.piece_bytes()):
                            out[i] += b
        return out


class ShardedTrainer:
    """dp x tp trainer: any net with the ``do_step`` contract trains with
    parameters tensor-sharded over ``model`` and batches split over
    ``data``. The per-row batch is batch_size / mesh.shape['data'];
    batch_size must divide evenly.

    >>> mesh = data_model_mesh(2, 2)
    >>> trainer = ShardedTrainer(net, mesh)
    >>> trainer.fit(iterator, epochs=2)
    """

    def __init__(self, net, mesh: Mesh):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if DATA_AXIS not in mesh.shape or MODEL_AXIS not in mesh.shape:
            raise ValueError(
                f"mesh must have ({DATA_AXIS}, {MODEL_AXIS}) axes, got "
                f"{dict(mesh.shape)}")
        self.net = net
        self.mesh = mesh
        self.param_specs = shard_network(net, mesh)
        self._program = net._sharded

    def _check(self, ds):
        d = self.mesh.shape[DATA_AXIS]
        feats = ds.features
        n = (feats[0] if isinstance(feats, (list, tuple)) else feats).shape[0]
        if n % d != 0:
            raise ValueError(
                f"batch size {n} not divisible by data-axis size {d}")
        return ds

    def fit(self, iterator, epochs: int = 1):
        """Delegates to the net's own fit (listeners, epochs, the fused
        driver and the health guard all apply); the net's step slot holds
        the sharded step."""
        from deeplearning4j_torch.datasets.dataset import DataSet

        if isinstance(iterator, DataSet):
            return self.net.fit(self._check(iterator), epochs=epochs)
        return self.net.fit(_Checked(iterator, self._check), epochs=epochs)

    def output(self, x):
        """Sharded inference: batch over data, params stay tensor-sharded."""
        return self._program.output(x)

    def entry_bytes(self) -> list:
        """Param plus updater-state bytes on each mesh entry."""
        return self._program.entry_bytes()


class _Checked:
    """Wraps a DataSet iterable, checking each batch splits over data."""

    def __init__(self, it, check):
        self._it = it
        self._check = check

    def __iter__(self):
        return (self._check(ds) for ds in self._it)

    def reset(self):
        if hasattr(self._it, "reset"):
            self._it.reset()
