"""Port parity: the plain version of the flash-attention kernel K1
(``deeplearning4j_torch/ops/flash_attention.py``) against the JAX package's
Pallas flash forward, run in interpret mode as its own tests run it, and
against the JAX ``scaled_dot_attention``.

Tolerance: atol 1e-5 on O and lse, f32. The two sides reduce the same sums
in different orders (XLA CPU vs PyTorch CPU matmuls); nothing else differs.
f16 (head dims 8, 16 and 32): both sides compute in f32 and round O once to
f16, so they may differ by one f16 step of max|O| (2^-10·max|O|); lse stays
f32 (atol 1e-5).
The CUDA kernel itself cannot run here: ``chip_smoke.py`` holds it against
this plain version on the card.

The kernel's f32 arithmetic is rehearsed here in torch: every product as
three TF32 products of hi/lo splits (``cvt.rna.tf32.f32``: round to nearest,
ties away, emulated on the int32 view), 64-row q tiles over 64-key tiles
with the online softmax, as ``kernels/flash_fwd.cu`` runs them. It must meet
``chip_smoke.py`` phase 2's atol 1e-4 against the plain version and the JAX
Pallas forward; one TF32 product per product must not. Its f16 path (exact
f16 products summed in f32, P entering P·V as two f16 terms, O rounded once)
must meet phase 2's 2^-8·max|O| at head dims 8 and 16.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.conf.layers.attention import (  # noqa: E402
    scaled_dot_attention as jax_sdpa)
from deeplearning4j_tpu.ops.pallas_attention import (  # noqa: E402
    _flash_forward)
from deeplearning4j_torch.ops import flash_attention as fa  # noqa: E402
from tf32_emulation import _mm_tf32, _mm_tf32x3, _tf32  # noqa: E402

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, T, D = 2, 3, 16, 8


def _inputs(seed, masked):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 11:] = 0                          # right padding
        mask[1, rs.permutation(T)[:5]] = 0        # holes
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_matches_jax_flash_and_sdpa(causal, masked):
    q, k, v, mask = _inputs(int(causal) * 2 + int(masked), masked)
    jm = None if mask is None else jnp.asarray(mask)
    jo, jlse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jm, causal=causal, block_q=T, block_k=T,
                              interpret=True)
    ref_sdpa = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, mask=jm))
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal,
                                      mask=tm)
    assert o.shape == (B, H, T, D) and o.dtype == torch.float32
    assert lse.shape == (B * H, T, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), ref_sdpa, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wrapper_on_cpu_is_the_plain_version(causal):
    """On CPU tensors the wrapper returns exactly the plain version's
    result and counts no launch."""
    from deeplearning4j_torch import kernels

    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(5, True))
    before = dict(kernels.LAUNCHES)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal, mask=mask)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal, mask=mask)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert kernels.LAUNCHES == before


def test_bf16_plain_keeps_input_dtype():
    q, k, v, _ = _inputs(6, False)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, lse = fa.flash_attention_plain(qb, kb, vb, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = fa.flash_attention_plain(qb.float(), kb.float(), vb.float(),
                                      causal=True)
    np.testing.assert_allclose(o.float().numpy(), ref.numpy(), atol=2e-2)


@pytest.mark.parametrize("d", [8, 16, 32], ids=["d8", "d16", "d32"])
@pytest.mark.parametrize("dtype", ["float32", "float16"], ids=["f32", "f16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_head_dims_and_f16_match_jax_flash(d, dtype, causal):
    """Head dims 8, 16 and 32 in f32 and f16, masked, against the JAX
    Pallas forward in interpret mode."""
    rs = np.random.RandomState(40 + d + int(causal))
    q, k, v = (rs.randn(B, H, T, d).astype(dtype) for _ in range(3))
    mask = np.ones((B, T), np.float32)
    mask[0, 11:] = 0
    jo, jlse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), causal=causal, block_q=T,
                              block_k=T, interpret=True)
    o, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, mask=torch.from_numpy(mask))
    jo = np.asarray(jo).astype(np.float32)
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    atol = 1e-5 if dtype == "float32" else 2.0 ** -10 * np.abs(jo).max()
    np.testing.assert_allclose(o.float().numpy(), jo, atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=0)


def test_supports():
    assert fa.supports((2, 8, 128, 32), mask=None)
    assert fa.supports((2, 8, 100, 64), mask=torch.ones(2, 100),
                       dtype=torch.bfloat16)
    # head dims: 1..256 (padded to the next kernel width where d has no
    # instantiation of its own); over 256 refused (ROADMAP B3 (c))
    for d in (1, 2, 4, 6, 12, 48, 50, 80, 96, 120, 132, 160, 200, 256):
        assert fa.supports((2, 8, 128, d), mask=None)
    for d in (0, 257, 320, 512):
        assert not fa.supports((2, 8, 128, d), mask=None)
    for d in (8, 16):
        assert fa.supports((2, 8, 128, d), mask=None)
        assert fa.supports((2, 8, 128, d), mask=None, dtype=torch.float16)
    assert not fa.supports((2, 8, 128, 32), mask=torch.ones(2, 8, 128))
    assert not fa.supports((2, 8, 128, 32), mask=None, dtype=torch.float64)
    assert not fa.supports((8, 128, 32), mask=None)


# ------------------------------------------------- K1's f32 design, rehearsed
def _k1_emulated(q, k, v, *, causal, mask, mm, block=64, mm_p=None,
                 scale=None):
    """K1's tile walk in f32: 64-row q tiles, 64-key tiles up to the causal
    limit, scores scaled after the product (by ``scale``, default
    1/√d), masked keys -1e30 and keys past T -inf, online softmax, l
    clamped at 1e-30. ``mm`` runs q·kᵀ, ``mm_p`` (default ``mm``) P·V.
    Returns (o, lse)."""
    mm_p = mm if mm_p is None else mm_p
    B, H, T, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, 1)
    for q0 in range(0, T, block):
        rows = torch.arange(q0, min(q0 + block, T))
        qt = q[:, :, q0:q0 + block]
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), d)
        kend = min(T, q0 + block) if causal else T
        for k0 in range(0, kend, block):
            cols = torch.arange(k0, k0 + block)
            kt = torch.zeros(B, H, block, d)
            vt = torch.zeros(B, H, block, d)
            n = min(block, T - k0)
            kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
            s = mm(qt, kt.transpose(-1, -2)) * scale
            masked = torch.zeros(B, 1, len(rows), block, dtype=torch.bool)
            if causal:
                masked = masked | (cols[None, None, None, :]
                                   > rows[None, None, :, None])
            if mask is not None:
                valid = torch.zeros(B, block)
                valid[:, :n] = mask[:, k0:k0 + n]
                masked = masked | (valid == 0)[:, None, None, :]
            s = torch.where(masked, torch.full_like(s, -1e30), s)
            s = torch.where(cols >= T, torch.full_like(s, -math.inf), s)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - mx), torch.exp(s - mx)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + mm_p(p, vt)
            m = mx
        lc = l.clamp_min(1e-30)
        o[:, :, q0:q0 + block] = acc / lc
        lse[:, :, q0:q0 + block] = m + torch.log(lc)
    return o, lse.reshape(B * H, T, 1)


def _k1_case(masked):
    rs = np.random.RandomState(20 + int(masked))
    q, k, v = (rs.randn(2, 2, 128, 32).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((2, 128), np.float32)
        mask[0, 100:] = 0                             # right padding
        mask[1, 1 + rs.permutation(127)[:40]] = 0     # holes; key 0 valid
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_k1_tf32x3_design_meets_phase2_tolerance(masked):
    """K1's three-TF32-product f32 design over its 64 x 64 tiles, at [2, 2,
    128, 32] causal, within chip_smoke phase 2's atol 1e-4 of the plain
    version and of the JAX Pallas forward (interpret mode)."""
    q, k, v, mask = _k1_case(masked)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = _k1_emulated(tq, tk, tv, causal=True, mask=tm, mm=_mm_tf32x3)
    po, plse = fa.flash_attention_plain(tq, tk, tv, causal=True, mask=tm)
    jo, jlse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask),
                              causal=True, block_q=128, block_k=128,
                              interpret=True)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), po.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-4,
                               rtol=0)


def test_k1_single_tf32_product_misses_phase2_tolerance():
    """Why the kernel pays for three products: with one TF32 product per
    product the same walk leaves the 1e-4 band that the serve's output()
    and the training gradients are held to."""
    q, k, v, _ = _k1_case(False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    po, _ = fa.flash_attention_plain(tq, tk, tv, causal=True)
    one, _ = _k1_emulated(tq, tk, tv, causal=True, mask=None, mm=_mm_tf32)
    three, _ = _k1_emulated(tq, tk, tv, causal=True, mask=None,
                            mm=_mm_tf32x3)
    err_one = (one - po).abs().max().item()
    err_three = (three - po).abs().max().item()
    assert err_one > 1e-4 > 10 * err_three


@pytest.mark.parametrize("d", [8, 16], ids=["d8", "d16"])
def test_k1_design_at_small_head_dims(d):
    """K1 at head dims 8 and 16: f32 as three TF32 products (one and two
    k-steps) within phase 2's atol 1e-4 of the plain version and the JAX
    Pallas forward; f16 with exact products summed in f32 and P in two f16
    terms (the m16n8k8 score product and the two-k-step P·V of d=8) within
    phase 2's 2^-8·max|O| of the plain f16 version."""
    rs = np.random.RandomState(50 + d)
    q, k, v = (rs.randn(2, 2, 128, d).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, _ = _k1_emulated(tq, tk, tv, causal=True, mask=None, mm=_mm_tf32x3)
    po, _ = fa.flash_attention_plain(tq, tk, tv, causal=True)
    jo, _ = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           None, causal=True, block_q=128, block_k=128,
                           interpret=True)
    np.testing.assert_allclose(o.numpy(), po.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-4, rtol=0)

    def mm_f16_terms(a, b):                       # lo first, then hi
        hi = a.half().float()
        return (a - hi).half().float() @ b + hi @ b

    hq, hk, hv = (t.half() for t in (tq, tk, tv))
    o16, _ = _k1_emulated(hq.float(), hk.float(), hv.float(), causal=True,
                          mask=None, mm=torch.matmul, mm_p=mm_f16_terms)
    p16, _ = fa.flash_attention_plain(hq, hk, hv, causal=True)
    err = (o16.half().float() - p16.float()).abs().max().item()
    assert err <= 2.0 ** -8 * p16.float().abs().max().item()


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    got = _tf32(x)
    # a tie (2^-11 above 1 is half a TF32 step) rounds away from zero
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                            -(1.0 + 2.0 ** -10), 1.0, 3.0]
