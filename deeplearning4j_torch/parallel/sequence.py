"""Sequence/context parallelism over a mesh axis (port of
``deeplearning4j_tpu/parallel/sequence.py``).

- ``ring_attention``: the TIME axis of attention sharded over the axis;
  key/value blocks rotate around the ring with ``ppermute`` while each
  entry accumulates a streaming (online) softmax (Liu et al. 2023, Ring
  Attention).
- ``ulysses_attention``: two ``all_to_all``s re-shard from
  sequence-sharded ``[B, H, T/n, d]`` to head-sharded ``[B, H/n, T, d]``,
  each entry runs full-sequence attention for its heads, and the second
  all-to-all restores the sequence sharding (Jacobs et al. 2023,
  DeepSpeed-Ulysses).

The JAX module computes both with plain ``jnp`` inside ``shard_map``; the
port computes them with plain torch over per-entry blocks in mesh order,
the collectives being ``parallel.mesh.ppermute``/``all_to_all``. Every
step is differentiable, so gradients flow back around the ring.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_torch.nn.conf.layers.attention import (
    scaled_dot_attention)
from deeplearning4j_torch.parallel.mesh import (Mesh, all_gather, all_to_all,
                                                ppermute)

SEQ_AXIS = "seq"
_MIN_LOGIT = -1e4  # running-max clamp: keeps exp() well-defined for
_MASKED = -1e30    # fully-masked blocks (see _block_update)


def _block_update(q_blk, k_cur, v_cur, m, l, acc, q_off, k_off, causal):
    """One blockwise softmax accumulation step (online softmax)."""
    d = q_blk.shape[-1]
    logits = torch.matmul(q_blk, k_cur.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        Tq, Tk = logits.shape[-2], logits.shape[-1]
        qpos = q_off + torch.arange(Tq, device=logits.device)
        kpos = k_off + torch.arange(Tk, device=logits.device)
        keep = qpos[:, None] >= kpos[None, :]
        logits = torch.where(keep, logits,
                             torch.full_like(logits, _MASKED))
    row_max = torch.amax(logits, dim=-1)                      # [B,H,Tq]
    new_m = torch.clamp(torch.maximum(m, row_max), min=_MIN_LOGIT)
    p = torch.exp(logits - new_m[..., None])                  # [B,H,Tq,Tk]
    scale = torch.exp(m - new_m)                              # [B,H,Tq]
    l = l * scale + torch.sum(p, dim=-1)
    acc = acc * scale[..., None] + torch.matmul(p, v_cur)
    return new_m, l, acc


def _axis_devices(mesh: Mesh, axis: str) -> list:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis, got axes "
                         f"{mesh.axis_names}")
    mesh.require_one_process("sequence parallelism")
    ax = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, ax, 0).reshape(
        mesh.shape[axis], -1)[:, 0])


def _split_time(t, devices):
    n = len(devices)
    if t.shape[2] % n:
        raise ValueError(f"sequence length {t.shape[2]} not divisible by "
                         f"the axis size {n}")
    return [c.to(dv) for c, dv in zip(torch.chunk(t, n, dim=2), devices)]


def ring_attention(q, k, v, *, mesh: Mesh, axis: str = SEQ_AXIS,
                   causal: bool = False):
    """Exact attention with the time axis sharded over ``axis``.
    q/k/v: [B, H, T, d] tensors (T divisible by the axis size). Returns
    [B, H, T, d] on q's device, equal to single-device
    softmax(qk^T/sqrt(d))v up to float tolerance."""
    devs = _axis_devices(mesh, axis)
    n = len(devs)
    qs, ks, vs = (_split_time(t, devs) for t in (q, k, v))
    Tl = qs[0].shape[2]
    state = []
    for qb in qs:
        m0 = torch.full(qb.shape[:3], _MIN_LOGIT, dtype=qb.dtype,
                        device=qb.device)
        state.append((m0, torch.zeros_like(m0), torch.zeros_like(qb)))
    for step in range(n):
        # after `step` rotations, entry i holds block (i - step) % n
        state = [_block_update(qs[i], ks[i], vs[i], *state[i], i * Tl,
                               ((i - step) % n) * Tl, causal)
                 for i in range(n)]
        if step < n - 1:
            ks, vs = ppermute(ks), ppermute(vs)
    outs = [acc / torch.clamp(l, min=1e-12)[..., None]
            for _, l, acc in state]
    return all_gather(outs, q.device, dim=2)


def ulysses_attention(q, k, v, *, mesh: Mesh, axis: str = SEQ_AXIS,
                      causal: bool = False):
    """All-to-all (DeepSpeed-Ulysses style) sequence parallelism:
    sequence-sharded blocks become head-sharded by one all-to-all, each
    entry runs full-sequence attention for its heads, and a second
    all-to-all restores sequence sharding. Requires H divisible by the
    axis size. q/k/v: [B, H, T, d]; returns [B, H, T, d] on q's device."""
    devs = _axis_devices(mesh, axis)
    n = len(devs)
    H = q.shape[1]
    if H % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({H}) divisible by the "
            f"'{axis}' axis size ({n}); use ring_attention otherwise")
    # seq-sharded -> head-sharded: split heads, concat time blocks
    # (entry order == time order, so the concatenation is the sequence)
    ql, kl, vl = (all_to_all(_split_time(t, devs), 1, 2) for t in (q, k, v))
    o = [scaled_dot_attention(a, b, c, causal=causal)
         for a, b, c in zip(ql, kl, vl)]
    # head-sharded -> seq-sharded
    return all_gather(all_to_all(o, 2, 1), q.device, dim=2)


def sequence_parallel_self_attention(layer, params, x, *, mesh: Mesh,
                                     axis: str = SEQ_AXIS, causal=None,
                                     impl: str = "ring"):
    """A SelfAttentionLayer forward with the sequence axis sharded: the
    projections are pointwise in time; the attention core is the ring
    (``impl='ring'``) or two all-to-alls (``impl='ulysses'``, heads
    divisible by the axis size). Inference-mode equal to ``layer.forward``
    (output activation included; no mask: pad to multiples of the axis
    size instead)."""
    causal = layer.causal if causal is None else causal
    H = layer.n_heads

    def project(W):
        y = torch.matmul(x, W)
        B, T, O = y.shape
        return y.reshape(B, T, H, O // H).permute(0, 2, 1, 3)

    impls = {"ring": ring_attention, "ulysses": ulysses_attention}
    if impl not in impls:
        raise ValueError(f"impl must be one of {sorted(impls)}, "
                         f"got '{impl}'")
    q, k, v = (project(params["Wq"]), project(params["Wk"]),
               project(params["Wv"]))
    o = impls[impl](q, k, v, mesh=mesh, axis=axis, causal=causal)
    B, H_, T, d = o.shape
    o = o.permute(0, 2, 1, 3).reshape(B, T, H_ * d)
    out = torch.matmul(o, params["Wo"]) + params["b"]
    return layer.act()(out)
