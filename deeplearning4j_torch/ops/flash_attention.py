"""Flash attention: the hand-written Hopper kernels K1 (forward), K3 (dQ)
and K4 (dK/dV), their plain PyTorch versions and the autograd Function that
joins them (port of ``deeplearning4j_tpu/ops/pallas_attention.py``).

``softmax(q kᵀ / √d) v`` over ``[B, H, T, d]`` with an optional causal mask
and an optional ``[B, T]`` key-validity row (nonzero = valid, shared by the
heads of a batch row). Masked scores are ``NEG_INF = -1e30``, not ``-inf``,
so a row whose keys are all masked stays finite. The forward returns the
output in the input dtype and the row logsumexp ``lse`` ``[B·H, T, 1]`` in
f32; the backward rebuilds the attention weights from that ``lse``.

The kernels (``kernels/flash_fwd.cu``, ``kernels/flash_bwd.cu``) replace
``_attn_fwd_kernel``, ``_attn_dq_kernel`` and ``_attn_dkv_kernel``.
``FlashAttention`` plays the part of the JAX ``custom_vjp``: its forward
saves ``(q, k, v, o, lse)``, its backward computes ``delta = rowsum(dO·O)``
and runs the two backward kernels.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_torch.kernels import (HEAD_DIM_RULE, count_launch,
                                          kernel_width)

NEG_INF = -1e30

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _scores(q, k, *, causal, mask):
    """``(q/√d) kᵀ`` in f32 with masked entries at ``NEG_INF``, and the
    pre-scaled f32 q."""
    T = q.shape[2]
    qs = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    if mask is not None:
        key_ok = (mask != 0)[:, None, None, :]
        s = torch.where(key_ok, s, torch.full_like(s, NEG_INF))
    return s, qs


def flash_attention_plain(q, k, v, *, causal: bool = False, mask=None):
    """The plain PyTorch version of K1: one dense softmax in f32 over the
    full ``[B, H, T, T]`` score matrix. Returns ``(o, lse)``."""
    B, H, T, d = q.shape
    s, _ = _scores(q, k, causal=causal, mask=mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l)).reshape(B * H, T, 1)
    return o.to(q.dtype), lse


def attention_delta(o, do):
    """``delta = rowsum(dO·O)`` ``[B·H, T, 1]`` in f32, over ``O`` in its
    stored dtype, as ``_flash_backward`` computes it outside its kernels."""
    B, H, T, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(B * H, T, 1)


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = False, mask=None):
    """The plain PyTorch version of K3 and K4: the attention weights rebuilt
    densely from the forward's ``lse`` as ``P = exp(s − lse)``, with ``q``
    pre-scaled and masked scores at ``NEG_INF``, then ``dS = P ⊙ (dP −
    delta)``, ``dq = dS k / √d``, ``dk = dSᵀ (q/√d)`` and ``dv = Pᵀ dO``.
    Returns ``(dq, dk, dv)`` in the input dtype."""
    B, H, T, d = q.shape
    s, qs = _scores(q, k, causal=causal, mask=mask)
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - attention_delta(o, do).reshape(B, H, T, 1))
    dq = torch.matmul(ds, k.float()) * (1.0 / math.sqrt(d))
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def supports(q_shape, *, mask, dtype=torch.float32) -> bool:
    """Whether the CUDA kernels take this case: a 4-D query, no mask or a
    ``[B, T]`` key-validity row, f32, bf16 or f16, and a head dim the
    kernels take (``kernels.kernel_width``: 1..256). Any T works: the
    kernels mask their ragged edge. A caller may
    ask before it hands CUDA tensors to the wrappers, which raise on a case
    the kernels do not take."""
    if len(q_shape) != 4:
        return False
    if mask is not None and tuple(mask.shape) != (q_shape[0], q_shape[2]):
        return False
    if dtype not in KERNEL_DTYPES:
        return False
    return kernel_width(q_shape[3]) is not None


def _cuda_case(q, k, v, mask):
    """Check a CUDA request against what the kernels take; raise on any
    other. Returns the key mask as contiguous f32 on q's device (or
    None)."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention has no path for device "
                           f"{q.device}")
    B, H, T, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes f32, bf16 or f16 q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kernel_width(d) is None:
        raise ValueError(f"flash kernel takes {HEAD_DIM_RULE}, got {d}")
    if mask is None:
        return None
    if tuple(mask.shape) != (B, T):
        raise ValueError(f"key mask shape {tuple(mask.shape)} != (B, T) "
                         f"= ({B}, {T})")
    return mask.to(device=q.device, dtype=torch.float32).contiguous()


def flash_attention_forward(q, k, v, *, causal: bool = False, mask=None):
    """K1's wrapper: ``(o, lse)``. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, mask=mask)
    mask = _cuda_case(q, k, v, mask)
    from deeplearning4j_torch import kernels

    ext = kernels.load()
    o, lse = ext.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           mask, bool(causal))
    count_launch("flash_fwd", q.shape[3])
    return o, lse


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = False,
                             mask=None):
    """K3's and K4's wrapper: ``(dq, dk, dv)`` from the forward's inputs,
    its output ``o`` and ``lse``, and the upstream gradient ``do``. CPU
    tensors take the plain version; CUDA tensors launch the two kernels or
    raise — there is no fallback."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do,
                                              causal=causal, mask=mask)
    mask = _cuda_case(q, k, v, mask)
    from deeplearning4j_torch import kernels

    ext = kernels.load()
    delta = attention_delta(o, do)
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            do.to(q.dtype).contiguous(), lse.contiguous(), delta, mask,
            bool(causal))
    dq = ext.flash_bwd_dq(*args)
    count_launch("flash_bwd_dq", q.shape[3])
    dk, dv = ext.flash_bwd_dkv(*args)
    count_launch("flash_bwd_dkv", q.shape[3])
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``softmax(q kᵀ/√d) v`` with the flash backward (the port of the
    ``custom_vjp`` in ``flash_attention``). The key mask takes no gradient
    (``None``; JAX returns zeros)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        # contiguous once here, so the backward wrapper copies nothing
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_forward(q, k, v, causal=causal, mask=mask)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              causal=ctx.causal, mask=mask)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, mask=None):
    """``softmax(q kᵀ/√d) v``, the output only. With grad enabled it goes
    through ``FlashAttention``, so a backward runs K3 and K4; otherwise
    straight through K1's wrapper."""
    if torch.is_grad_enabled():
        return FlashAttention.apply(q, k, v, mask, causal)
    return flash_attention_forward(q, k, v, causal=causal, mask=mask)[0]
