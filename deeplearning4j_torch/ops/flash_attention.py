"""Flash-attention forward: the hand-written Hopper kernel K1 and its plain
PyTorch version (port of ``deeplearning4j_tpu/ops/pallas_attention.py``).

``softmax(q kᵀ / √d) v`` over ``[B, H, T, d]`` with an optional causal mask
and an optional ``[B, T]`` key-validity row (nonzero = valid, shared by the
heads of a batch row). Masked scores are ``NEG_INF = -1e30``, not ``-inf``,
so a row whose keys are all masked stays finite. Returns the output in the
input dtype and the row logsumexp ``lse`` ``[B·H, T, 1]`` in f32, which the
training slice's backward kernels will consume.

The kernel (``kernels/flash_fwd.cu``) replaces ``_attn_fwd_kernel``. Only the
forward is ported; the backward kernels wait for the training slice.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = False, mask=None):
    """The plain PyTorch version of K1: one dense softmax in f32 over the
    full ``[B, H, T, T]`` score matrix. Returns ``(o, lse)``."""
    B, H, T, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    if mask is not None:
        key_ok = (mask != 0)[:, None, None, :]
        s = torch.where(key_ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l)).reshape(B * H, T, 1)
    return o.to(q.dtype), lse


def supports(q_shape, *, mask, dtype=torch.float32) -> bool:
    """Whether the CUDA kernel takes this case: a 4-D query, no mask or a
    ``[B, T]`` key-validity row, f32 or bf16, and a head dim the kernel is
    built for. Any T works: the kernel masks its ragged edge. A caller may
    ask before it hands CUDA tensors to the wrapper, which raises on a case
    the kernel does not take."""
    if len(q_shape) != 4:
        return False
    if mask is not None and tuple(mask.shape) != (q_shape[0], q_shape[2]):
        return False
    if dtype not in KERNEL_DTYPES:
        return False
    return q_shape[3] in KERNEL_HEAD_DIMS


def flash_attention_forward(q, k, v, *, causal: bool = False, mask=None):
    """K1's wrapper: ``(o, lse)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, mask=mask)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention has no path for device "
                           f"{q.device}")
    B, H, T, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes f32 or bf16 q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if mask is not None:
        if tuple(mask.shape) != (B, T):
            raise ValueError(f"key mask shape {tuple(mask.shape)} != (B, T) "
                             f"= ({B}, {T})")
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    from deeplearning4j_torch import kernels

    ext = kernels.load()
    o, lse = ext.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           mask, bool(causal))
    kernels.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, *, causal: bool = False, mask=None):
    """``softmax(q kᵀ/√d) v`` through K1's wrapper; the output only."""
    return flash_attention_forward(q, k, v, causal=causal, mask=mask)[0]
