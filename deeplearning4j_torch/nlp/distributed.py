"""Distributed embedding training: vocab-row sharding over a device mesh
(port of ``deeplearning4j_tpu/nlp/distributed.py``).

Reference: dl4j-spark-nlp Word2Vec.java:136-187 averages word vectors
across a cluster every epoch. The JAX module shards the lookup tables
themselves by vocabulary row over the mesh's ``model`` axis and runs the
same epoch programs under GSPMD. The port stores each table as a
:class:`RowShardedTable`, one contiguous block of rows on each ``model``
entry, and the same batch loop (``nlp/learning.py``) gathers rows from the
entries that own them and ``index_add_``s each update into its owner's
rows: exact where Spark's averaging is approximate, and a [V, D] table
past one card's memory. Results equal unsharded training up to the
summation order of the adds (allclose on CUDA, whose ``index_add_`` adds
with atomics; ROADMAP C5).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.parallel.mesh import (MODEL_AXIS, Mesh,
                                                ShardedTensor)

__all__ = ["shard_embedding_tables", "sharded_vocab_rows",
           "RowShardedTable"]


def _model_devices(mesh: Mesh) -> list:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh has no {MODEL_AXIS!r} axis, got axes "
                         f"{mesh.axis_names}")
    mesh.require_one_process("a row-sharded table")
    ax = mesh.axis_names.index(MODEL_AXIS)
    return list(np.moveaxis(mesh.devices, ax, 0).reshape(
        mesh.shape[MODEL_AXIS], -1)[:, 0])


def sharded_vocab_rows(num_words: int, mesh: Mesh) -> int:
    """Table row count after padding to the model-axis size (padded rows
    are never indexed: all vocab ids, huffman points and negative-table
    entries are < num_words)."""
    m = mesh.shape[MODEL_AXIS]
    return ((num_words + m - 1) // m) * m


class RowShardedTable(ShardedTensor):
    """A [V, D] table stored as m contiguous row blocks (the pieces along
    dim 0), block s on model entry s. Indexing with a tensor gathers each
    row from its owner onto the first entry's device (every owner gathers
    its clamped indices, and a select keeps the owner's rows: no host
    sync); ``index_add_`` adds each row's updates on its owner, an update
    for another owner's row adding 0.0 to a row of the block spread by its
    position (x + 0.0 is x, and no row takes them all). Any other read
    assembles the whole table."""

    def __init__(self, blocks: list):
        super().__init__(blocks, 0)
        self.rows = int(blocks[0].shape[0])

    @property
    def blocks(self) -> list:
        return self.pieces

    def _local(self, idx, s):
        local = idx - s * self.rows
        own = (local >= 0) & (local < self.rows)
        return torch.clamp(local, 0, self.rows - 1), own

    def __getitem__(self, idx):
        if not torch.is_tensor(idx):
            return self.gather()[idx]
        out = None
        for s, blk in enumerate(self.blocks):
            local, own = self._local(idx.to(self.device), s)
            rows = blk[local.to(blk.device)].to(self.device)
            out = rows if out is None else torch.where(
                own.reshape(own.shape + (1,) * (rows.dim() - own.dim())),
                rows, out)
        return out

    def index_add_(self, dim: int, idx, src):
        if dim != 0:
            raise ValueError("a row-sharded table adds along its rows")
        idx = idx.to(self.device)
        spread = torch.arange(idx.shape[0], device=idx.device) % self.rows
        for s, blk in enumerate(self.blocks):
            local, own = self._local(idx, s)
            upd = torch.where(own.reshape((-1,) + (1,) * (src.dim() - 1)),
                              src, src.new_zeros(()))
            blk.index_add_(0, torch.where(own, local, spread).to(blk.device),
                           upd.to(blk.device))
        return self


def shard_embedding_tables(model, mesh: Mesh):
    """Place ``model``'s syn0 / syn1 / syn1neg row-sharded over ``mesh``'s
    model axis (rows padded up to a multiple of the axis size; each table
    pads to its own multiple). Later ``fit`` calls run the device epoch
    loop over the sharded tables, which stay sharded across epochs.
    Works for Word2Vec / SequenceVectors / ParagraphVectors alike: they
    share the table layout. Call after ``build_vocab``/``reset_weights``
    (or after a fit: resharding existing tables is fine)."""
    devices = _model_devices(mesh)
    if model.syn0 is None:
        model.reset_weights()

    def place(t):
        if isinstance(t, RowShardedTable):
            t = t.gather()
        t = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t)
        pad = sharded_vocab_rows(t.shape[0], mesh) - t.shape[0]
        if pad:
            t = torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]),
                                          dtype=t.dtype, device=t.device)])
        return RowShardedTable([b.to(d, copy=True).contiguous() for b, d in
                                zip(torch.chunk(t, len(devices)), devices)])

    model.syn0 = place(model.syn0)
    model.syn1 = place(model.syn1)
    model.syn1neg = place(model.syn1neg)
    return model
