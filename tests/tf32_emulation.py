"""Torch emulation of the f32 arithmetic of the port's tensor-core kernels,
shared by the port's CPU rehearsals (``test_torch_flash_attention.py``,
``test_torch_flash_backward.py``).

On the card an f32 product runs as TF32 ``mma.sync``: each operand is split
into a TF32 hi and a rounded TF32 lo and three products are summed (hi·hi +
hi·lo + lo·hi; lo·lo dropped), as ``kernels/mma.cuh`` does it.
"""

import torch


def _tf32(x):
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to
    the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32x3(a, b):
    """a @ b as the kernel's three TF32 products: lo·hi + hi·lo + hi·hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_tf32(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)
