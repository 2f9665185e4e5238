"""Paged-attention helper seam (port of
``deeplearning4j_tpu/nn/conf/layers/paged_attention.py``): the plain
gather-then-attend version and the hand-written Hopper kernel K2.

- :class:`XlaPagedAttention` keeps the JAX name of the stock backend. It
  gathers each row's block table into a dense ``[B, H, Tmax, d]`` view and
  attends: the twin of the JAX gather path, and the plain version of K2.
- :class:`CudaPagedAttention` reads the pages in place through the block
  table with K2 (``kernels/paged_attn.cuh``). It never builds the gathered
  view. K2 takes f32, bf16 and f16 queries over pages of the query's
  dtype or int8, at every head dim 1..256 (``kernels.kernel_width``,
  ``decode_width``), and computes in f32 as
  the Pallas kernel does; the plain version computes in the query's
  dtype, as the JAX gather does.

The knob keeps the JAX values so a JAX ``configuration.json`` stays readable:
``"pallas"`` names the Hopper kernel; ``"xla"`` and ``"stock"`` the plain
version; ``"auto"`` resolves to the kernel for CUDA tensors and to the plain
version for CPU tensors. Only the READ side lives behind the seam; the
chunk write into the pool stays in ``SelfAttentionLayer._paged_forward``.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_torch.kernels import (HEAD_DIM_RULE, count_launch,
                                          kernel_width)

NEG_INF = -1e30

BACKENDS = ("xla", "pallas")
CHOICES = ("auto", "stock") + BACKENDS

#: query dtypes K2 takes; its pools are of the query's dtype or int8
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: query chunks of up to this many rows take K2's decode route, longer ones
#: its chunk route (``kDecodeMaxT`` in ``kernels/paged_attn.cuh``)
DECODE_MAX_T = 4


def _key_valid_plane(mask, pos, T, Tmax):
    """[B, Tmax] key validity over the cache axis for a masked chunk:
    columns belonging to this chunk take the chunk mask, everything older
    stays valid. Shared by both backends (the kernel takes the plane as an
    input) so the masking arithmetic cannot drift."""
    colv = torch.arange(Tmax, device=pos.device)[None, :]
    rel = colv - pos.long()[:, None]                           # [B, Tmax]
    chunk_valid = torch.gather(mask != 0, 1, rel.clamp(0, T - 1))
    inside = (rel >= 0) & (rel < T)
    return torch.where(inside, chunk_valid, torch.ones_like(chunk_valid))


def paged_attention_plain(q, kp, vp, bt, pos, *, key_valid=None,
                          kscales=None, vscales=None):
    """The plain version of K2: gather the pages named by ``bt`` into a
    dense ``[B, H, Tmax, d]`` view, then one masked softmax over it, all in
    q's dtype (int8 pages dequantized in q's dtype), as the JAX package's
    ``XlaPagedAttention`` computes it."""
    B, _H, T, d = q.shape
    ps = kp.shape[2]
    NP = bt.shape[1]
    Tmax = NP * ps
    btl = bt.long()
    # [B, NP, H, ps, d] -> [B, H, Tmax, d]
    kc = kp[btl].transpose(1, 2).reshape(B, -1, Tmax, kp.shape[-1])
    vc = vp[btl].transpose(1, 2).reshape(B, -1, Tmax, vp.shape[-1])
    if kscales is not None:
        ksv = kscales[btl].transpose(1, 2).reshape(B, -1, Tmax)
        vsv = vscales[btl].transpose(1, 2).reshape(B, -1, Tmax)
        kc = kc.to(q.dtype) * ksv[..., None].to(q.dtype)
        vc = vc.to(q.dtype) * vsv[..., None].to(q.dtype)
    logits = torch.matmul(q, kc.transpose(-1, -2)) / math.sqrt(d)
    col = torch.arange(Tmax, device=q.device)[None, None, None, :]
    row = torch.arange(T, device=q.device)[None, None, :, None]
    keep = col <= pos.long().reshape(-1, 1, 1, 1) + row
    if key_valid is not None:
        keep = keep & (key_valid != 0)[:, None, None, :]
    # -1e30 cast to the logits' dtype, as JAX casts the Python scalar (f16:
    # -inf)
    neg = float(torch.tensor(NEG_INF).to(logits.dtype))
    logits = torch.where(keep, logits, neg)
    return torch.matmul(torch.softmax(logits, dim=-1), vc)


def paged_attention(q, kp, vp, bt, pos, *, key_valid=None, kscales=None,
                    vscales=None, split_heads=None):
    """K2's wrapper. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise — there is no fallback. Counts every launch under
    ``paged_attn``, chunk-route launches also under ``paged_attn_chunk``,
    and the chunk route's merge pass (when it splits the walk) under
    ``paged_attn_merge``.

    ``split_heads``: the head count whose split rule the chunk route
    follows (default: q's). A head-parallel shard of ``H/tp`` heads passes
    the model's full ``H``, so its walk is cut into the ranges tp=1 cuts
    and its softmax merges in the same order: tp>1 stays bitwise tp=1."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, kp, vp, bt, pos, key_valid=key_valid,
                                     kscales=kscales, vscales=vscales)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged attention has no path for device "
                           f"{q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"paged kernel takes a query of {KERNEL_DTYPES}, "
                        f"got {q.dtype}")
    if kernel_width(q.shape[3]) is None:
        raise ValueError(f"paged kernel takes {HEAD_DIM_RULE}, got "
                         f"{q.shape[3]}")
    if key_valid is not None:
        key_valid = key_valid.to(torch.float32).contiguous()
    from deeplearning4j_torch import kernels

    ext = kernels.load()
    B, H, T, d = q.shape
    # the chunk route's split count, by the rule of the full head count
    # when a head shard passes it; 0 on the decode route, where the binding
    # applies its own rule (one range)
    splits = 0
    if T > DECODE_MAX_T:
        splits = ext.paged_attn_splits(B, split_heads or H, T, d,
                                       kp.shape[2], bt.shape[1],
                                       pool_kind(kp))
    o = ext.paged_attn(
        q.contiguous(), kp, vp, kscales, vscales,
        bt.to(torch.int32).contiguous(), pos.to(torch.int32).contiguous(),
        key_valid, splits)
    count_launch("paged_attn", d)
    if T > DECODE_MAX_T:
        count_launch("paged_attn_chunk", d)
        if splits > 1:
            count_launch("paged_attn_merge", d)
    return o


def pool_kind(kp) -> int:
    """The pools' element as ``paged_attn.cuh`` names it: 0 f32, 1 int8
    codes, 2 bf16/f16 (it sets the chunk route's key tile)."""
    if kp.dtype == torch.int8:
        return 1
    return 0 if kp.dtype == torch.float32 else 2


class PagedAttentionHelper:
    """One paged-attention read backend: attend a ``[B, H, T, d]`` query
    chunk over the pool pages its block table names. ``attend`` returns the
    pre-projection context ``[B, H, T, d]``; writing the fresh chunk into the
    pool is NOT the helper's job (the seam covers reads only)."""

    name = "base"

    def attend(self, q, kp, vp, bt, pos, *, mask=None, kscales=None,
               vscales=None, split_heads=None):
        raise NotImplementedError

    @staticmethod
    def _plane(q, kp, bt, pos, mask):
        if mask is None:
            return None
        return _key_valid_plane(mask, pos, q.shape[2],
                                bt.shape[1] * kp.shape[2])


class XlaPagedAttention(PagedAttentionHelper):
    """Stock backend: gather-then-attend, the plain version of K2."""

    name = "xla"

    def attend(self, q, kp, vp, bt, pos, *, mask=None, kscales=None,
               vscales=None, split_heads=None):
        return paged_attention_plain(
            q, kp, vp, bt, pos, key_valid=self._plane(q, kp, bt, pos, mask),
            kscales=kscales, vscales=vscales)


class CudaPagedAttention(PagedAttentionHelper):
    """Accelerated backend: K2 walks the block table in place."""

    name = "pallas"

    def attend(self, q, kp, vp, bt, pos, *, mask=None, kscales=None,
               vscales=None, split_heads=None):
        return paged_attention(
            q, kp, vp, bt, pos, key_valid=self._plane(q, kp, bt, pos, mask),
            kscales=kscales, vscales=vscales, split_heads=split_heads)


_HELPERS = {"xla": XlaPagedAttention(), "pallas": CudaPagedAttention()}


def resolve_paged_backend(choice, device) -> str:
    """Resolve a ``paged_attention`` knob to ``"pallas"`` (the kernel) or
    ``"xla"`` (the plain version). ``"auto"`` picks the kernel for CUDA
    tensors and the plain version for CPU tensors, and nothing else."""
    if choice not in CHOICES:
        raise ValueError(f"unknown paged_attention backend {choice!r} "
                         f"(expected one of {CHOICES})")
    if choice == "stock":
        return "xla"
    if choice != "auto":
        return choice
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def get_paged_helper(backend) -> PagedAttentionHelper:
    try:
        return _HELPERS[backend]
    except KeyError:
        raise ValueError(f"unknown paged_attention backend {backend!r} "
                         f"(expected one of {BACKENDS})") from None


def paged_attend(backend, q, kp, vp, bt, pos, *, mask=None, kscales=None,
                 vscales=None, split_heads=None):
    """Dispatch one paged-attention read through the resolved backend
    (``split_heads`` as for :func:`paged_attention`)."""
    return get_paged_helper(backend).attend(q, kp, vp, bt, pos, mask=mask,
                                            kscales=kscales, vscales=vscales,
                                            split_heads=split_heads)
