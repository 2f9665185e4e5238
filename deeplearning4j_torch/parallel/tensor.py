"""Tensor parallelism: Megatron-style sharded dense pairs over a mesh axis
(port of ``deeplearning4j_tpu/parallel/tensor.py``).

The first dense of a pair is COLUMN-sharded (activations stay sharded, no
communication), the second is ROW-sharded and finishes with ONE ``psum``
over the model axis (Shoeybi et al. 2019). On a 2-D (data, model) mesh
this composes with data parallelism: the batch split over ``data``,
weights over ``model``. The JAX module writes the block inside
``shard_map``; the port writes it over per-entry tensors in mesh order,
the psum being ``parallel.mesh.psum``.

For tensor-parallel training of whole networks use
``parallel.model_sharding.ShardedTrainer``.
"""

from __future__ import annotations

import torch

from deeplearning4j_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                                data_model_mesh, psum)
from deeplearning4j_torch.parallel.model_sharding import (P, SpecTensor,
                                                          _entry_grid)


def dp_tp_mesh(data: int, model: int, devices=None) -> Mesh:
    """2-D (data, model) mesh over the first data*model devices."""
    return data_model_mesh(data, model, devices=devices)


def tp_mlp_block(xs, w1, b1, w2, b2, activation):
    """Column-parallel dense -> activation -> row-parallel dense -> psum,
    over the entries of one model group: ``xs`` the input on each entry
    (replicated), ``w1``/``b1`` the column shards, ``w2`` the row shards,
    ``b2`` each entry's copy. Returns the output on each entry (the same
    values): exactly one collective, the psum, with ``b2`` added after
    it."""
    partial = [torch.matmul(activation(torch.matmul(x, a) + b), c)
               for x, a, b, c in zip(xs, w1, b1, w2)]
    return [o + b for o, b in zip(psum(partial), b2)]


def tp_specs():
    """PartitionSpecs for (x, w1, b1, w2, b2) of tp_mlp_block."""
    return (P(DATA_AXIS, None), P(None, MODEL_AXIS), P(MODEL_AXIS),
            P(MODEL_AXIS, None), P(None))


def tp_mlp_train_step(mesh: Mesh, activation, loss_fn, lr: float = 0.1):
    """A dp x tp training step for a 2-layer MLP: the batch split over
    ``data``, w1/b1 column- and w2 row-sharded over ``model``, b2
    replicated. Returns ``step(params, x, y) -> (params, loss)``;
    ``params`` is a dict of tensors or of the ``SpecTensor`` leaves a
    previous step returned (``np.asarray`` gathers one).

    The gradient, derived through the written-out psum: every model entry
    holds the same loss value, and the step differentiates their mean.
    The psum's backward hands each partial product the sum of the copies'
    cotangents, so a sharded leaf (w1, b1, w2) receives (1/m) * m = 1 times
    the gradient of the one logical loss and needs no rescaling; each copy
    of the replicated b2 receives 1/m of it, and the psum over ``model``
    of the copies' gradients restores it. Every leaf is then averaged over
    ``data`` (pmean), written out in mesh order."""
    grid = _entry_grid(mesh)
    D, M = grid.shape
    flat = mesh.flat
    specs = dict(zip(("w1", "b1", "w2", "b2"), tp_specs()[1:]))
    specs["b2"] = P()

    def place(params):
        return {k: v if isinstance(v, SpecTensor) else
                SpecTensor.place(torch.as_tensor(v), specs[k], mesh, grid)
                for k, v in params.items()}

    def step(params, x, y):
        params = place(params)
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape[0] % D:
            raise ValueError(f"batch size {x.shape[0]} not divisible by "
                             f"data-axis size {D}")
        xs, ys = torch.chunk(x, D), torch.chunk(y, D)
        leaves = {k: [p.detach().requires_grad_(True) for p in v.pieces]
                  for k, v in params.items()}
        losses = []
        with torch.enable_grad():
            for d in range(D):
                ent = [int(i) for i in grid[d]]
                devs = [flat[i] for i in ent]
                outs = tp_mlp_block(
                    [xs[d].to(dv) for dv in devs],
                    *([leaves[k][i] for i in ent]
                      for k in ("w1", "b1", "w2", "b2")), activation)
                for o, dv in zip(outs, devs):
                    losses.append(torch.mean(loss_fn(o, ys[d].to(dv))))
            home = losses[0].device
            total = sum(l_.to(home) for l_ in losses) / M
            names = list(leaves)
            gs = torch.autograd.grad(
                total, [t for k in names for t in leaves[k]],
                allow_unused=True)
        with torch.no_grad():
            it = iter(gs)
            grads = {k: [next(it) for _ in leaves[k]] for k in names}
            new = {}
            for k in names:
                g = [torch.zeros_like(t) if gg is None else gg
                     for gg, t in zip(grads[k], leaves[k])]
                if specs[k] == P():          # b2: psum over model
                    for d in range(D):
                        ent = [int(i) for i in grid[d]]
                        for i, s in zip(ent, psum([g[i] for i in ent])):
                            g[i] = s
                pieces = [None] * mesh.size
                for e in range(M):          # pmean over data
                    col = [int(grid[d, e]) for d in range(D)]
                    mean = psum([g[i] for i in col],
                                [flat[i] for i in col])
                    for i, gm in zip(col, mean):
                        pieces[i] = params[k].pieces[i] - lr * (gm / D)
                new[k] = SpecTensor(pieces, specs[k], mesh, grid)
            loss = psum([l_.detach() for l_ in losses],
                        [home] * len(losses))[0] / len(losses)
        return new, loss

    return step
