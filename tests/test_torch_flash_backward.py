"""Port parity: the plain version of the flash-attention backward kernels K3
(dQ) and K4 (dK/dV) (``deeplearning4j_torch/ops/flash_attention.py``)
against ``jax.grad`` through the JAX package's Pallas ``flash_attention``,
run in interpret mode as its own tests run it, and against
``torch.autograd`` through the port's ``scaled_dot_attention``; then the
autograd ``FlashAttention`` Function on CPU tensors.

Tolerances: ``max|Δ| ≤ 1e-5·max|g|`` per gradient, f32. The sides reduce the
same sums in other orders (XLA CPU vs PyTorch CPU matmuls) and the flash
form rebuilds P from the saved logsumexp, so they differ by f32 rounding
only. bf16: the plain backward on bf16 inputs keeps bf16 and stays within
``2e-2·max|g|`` of the f32 computation on the same (rounded) inputs. f16
(head dims 8, 16 and 32): both the plain backward and the JAX Pallas one
compute in f32 and round each gradient once to f16, within two f16 steps of
max|g| (``2^-9·max|g|``) of each other. The CUDA
kernels cannot run here: ``chip_smoke.py`` holds them against this plain
version on the card.

The kernels' design is rehearsed here in torch: K3's 64-row q tiles over
streamed K/V tiles and K4's 64-key tiles over streamed q/dO tiles (8 KB a
tensor: 64, 32 or 16 rows by the row's width), every f32 product as three TF32
products (``tf32_emulation.py``), bf16 with P and dS in two bf16 terms. It
must meet ``chip_smoke.py`` phase 6's bounds against the plain backward and
the JAX Pallas backward; one TF32 product per product must not. The f16
design (exact f16 products, P and dS in two f16 terms, one rounding at the
end) must meet phase 6's 2^-8·max|g| at head dims 8 and 16.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.pallas_attention import (  # noqa: E402
    flash_attention as jax_flash)
from deeplearning4j_torch.nn.conf.layers.attention import (  # noqa: E402
    scaled_dot_attention)
from deeplearning4j_torch.ops import flash_attention as fa  # noqa: E402
from tf32_emulation import _mm_tf32, _mm_tf32x3  # noqa: E402

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, T, D = 2, 3, 16, 8


def _inputs(seed, masked):
    """q, k, v, dO and an optional key mask. Key 0 stays valid in every
    row, so no causal query row is fully masked (ROADMAP §C: the flash
    form and a dense softmax differ on such rows)."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 11:] = 0                                  # right padding
        mask[1, 1 + rs.permutation(T - 1)[:5]] = 0        # holes
    return q, k, v, do, mask


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _plain_grads(q, k, v, do, mask, causal):
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.flash_attention_plain(*t[:3], causal=causal, mask=tm)
    return fa.flash_attention_backward_plain(*t[:3], o, lse, t[3],
                                             causal=causal, mask=tm)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_backward_matches_jax_pallas_grad(causal, masked):
    q, k, v, do, mask = _inputs(int(causal) * 2 + int(masked), masked)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=causal,
                                               mask=jm, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    got = _plain_grads(q, k, v, do, mask, causal)
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.float32 and g.shape == (B, H, T, D)
        assert _rel_err(g.numpy(), r) <= 1e-5, f"d{name}"


@pytest.mark.parametrize("d", [8, 16, 32], ids=["d8", "d16", "d32"])
@pytest.mark.parametrize("dtype", ["float32", "float16"], ids=["f32", "f16"])
def test_head_dims_and_f16_backward_match_jax(d, dtype):
    """Head dims 8, 16 and 32 in f32 and f16, causal and masked, against
    ``jax.vjp`` through the Pallas kernels in interpret mode."""
    rs = np.random.RandomState(60 + d)
    q, k, v, do = (rs.randn(B, H, T, d).astype(dtype) for _ in range(4))
    mask = np.ones((B, T), np.float32)
    mask[1, 1 + rs.permutation(T - 1)[:5]] = 0
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=True,
                                               mask=jm, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    got = _plain_grads(q, k, v, do, mask, True)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -9
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == getattr(torch, dtype) and g.shape == (B, H, T, d)
        assert _rel_err(g.float().numpy(), np.asarray(r).astype(
            np.float32)) <= tol, f"d{name}"


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_backward_matches_autograd_of_sdpa(causal, masked):
    q, k, v, do, mask = _inputs(10 + int(causal) * 2 + int(masked), masked)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    o = scaled_dot_attention(*leaves, causal=causal, mask=tm)
    ref = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    got = _plain_grads(q, k, v, do, mask, causal)
    for name, g, r in zip("qkv", got, ref):
        assert _rel_err(g.numpy(), r.numpy()) <= 1e-5, f"d{name}"


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_function_on_cpu_is_the_plain_version(causal):
    """Through ``flash_attention`` with grad enabled, CPU tensors take the
    plain forward and the plain backward exactly, and count no launch."""
    from deeplearning4j_torch import kernels

    q, k, v, do, mask = _inputs(20 + int(causal), True)
    tm = torch.from_numpy(mask)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = dict(kernels.LAUNCHES)
    o = fa.flash_attention(*leaves, causal=causal, mask=tm)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    assert kernels.LAUNCHES == before
    po, plse = fa.flash_attention_plain(*(t.detach() for t in leaves),
                                        causal=causal, mask=tm)
    ref = fa.flash_attention_backward_plain(
        *(t.detach() for t in leaves), po, plse, torch.from_numpy(do),
        causal=causal, mask=tm)
    assert torch.equal(o.detach(), po)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_wrapper_on_cpu_is_the_plain_version():
    from deeplearning4j_torch import kernels

    q, k, v, do, mask = (None if a is None else torch.from_numpy(a)
                         for a in _inputs(30, True))
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, mask=mask)
    before = dict(kernels.LAUNCHES)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                      mask=mask)
    ref = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal=True,
                                            mask=mask)
    assert kernels.LAUNCHES == before
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_no_grad_skips_the_function():
    q, k, v, _, _ = (torch.from_numpy(a) if a is not None else None
                     for a in _inputs(31, False))
    with torch.no_grad():
        o = fa.flash_attention(q.requires_grad_(True), k, v, causal=True)
    assert o.grad_fn is None


def test_delta_is_taken_over_stored_output():
    """delta = rowsum(dO·O) in f32 over O as stored (bf16 rounded), laid
    out [B·H, T, 1] like lse."""
    rs = np.random.RandomState(32)
    o = torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32)).bfloat16()
    do = torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32)).bfloat16()
    delta = fa.attention_delta(o, do)
    assert delta.shape == (B * H, T, 1) and delta.dtype == torch.float32
    ref = (do.float() * o.float()).sum(-1).reshape(B * H, T, 1)
    assert torch.equal(delta, ref)


# ---------------------------------------------- K3/K4's design, rehearsed
def _bf16_terms(x):
    """x as the kernels' two bf16 terms (hi + lo), as f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mm_bf16_split(a, b):
    """a @ b with a in two bf16 terms and b already bf16, as the kernels'
    bf16 P·dO, dS·q and dS·k products: lo first, then hi."""
    hi, lo = _bf16_terms(a)
    return lo @ b + hi @ b


def _tile(x, r0, n):
    """Rows [r0, r0 + n) of x along dim 2, zero past its end (the kernels'
    zero-filled cp.async rows)."""
    out = torch.zeros(*x.shape[:2], n, *x.shape[3:])
    got = x[:, :, r0:r0 + n]
    out[:, :, :got.shape[2]] = got
    return out


def _masked(rows, cols, T, causal, mask):
    """[B, 1, rows, cols] True where the score is -1e30: a key past the
    diagonal (causal) or refused by the key mask; keys past T are not
    refused here (the kernels drop them by other means)."""
    out = torch.zeros(1, 1, len(rows), len(cols), dtype=torch.bool)
    if causal:
        out = out | (cols[None, None, None, :] > rows[None, None, :, None])
    if mask is not None:
        valid = torch.zeros(mask.shape[0], len(cols))
        inside = cols < T
        valid[:, inside] = mask[:, cols[inside]]
        out = out | (valid == 0)[:, None, None, :]
    return out


def _k3k4_emulated(q, k, v, do, lse, delta, *, causal, mask, mm, mm_p,
                   block=64, stream=64):
    """K3's and K4's tile walks in f32. K3: ``block``-row q tiles over
    ``stream``-key K/V tiles up to the causal limit, dQ += dS·K, scaled by
    1/√d at the end. K4: ``block``-key tiles over ``stream``-row q/dO tiles
    from the tile holding the first key (causal), dV += Pᵀ·dO, dK += dSᵀ·q,
    dK scaled at the end. Scores are scaled after the product, refused keys
    score -1e30, keys or rows past T give P = 0. ``mm`` runs the score
    products (q·kᵀ, dO·vᵀ), ``mm_p`` those with P or dS as the left
    operand. Returns (dq, dk, dv) in f32."""
    B, H, T, d = q.shape
    scale = 1.0 / math.sqrt(d)
    lse, delta = lse.reshape(B, H, T, 1), delta.reshape(B, H, T, 1)
    dq, dk, dv = (torch.zeros(B, H, T, d) for _ in range(3))

    def probs(s, dp, rows, cols, lse_t, delta_t):
        s = torch.where(_masked(rows, cols, T, causal, mask),
                        torch.full_like(s, -1e30), s)
        p = torch.exp(s - lse_t)
        p = torch.where((rows[:, None] >= T) | (cols[None, :] >= T),
                        torch.zeros_like(p), p)
        return p, p * (dp - delta_t)

    for q0 in range(0, T, block):                       # K3
        rows = torch.arange(q0, q0 + block)
        qt, dot = _tile(q, q0, block), _tile(do, q0, block)
        lse_t, delta_t = _tile(lse, q0, block), _tile(delta, q0, block)
        acc = torch.zeros(B, H, block, d)
        kend = min(T, q0 + block) if causal else T
        for k0 in range(0, kend, stream):
            cols = torch.arange(k0, k0 + stream)
            kt, vt = _tile(k, k0, stream), _tile(v, k0, stream)
            s = mm(qt, kt.transpose(-1, -2)) * scale
            dp = mm(dot, vt.transpose(-1, -2))
            _, ds = probs(s, dp, rows, cols, lse_t, delta_t)
            acc = acc + mm_p(ds, kt)
        dq[:, :, q0:q0 + block] = (acc * scale)[:, :, :T - q0]

    for k0 in range(0, T, block):                       # K4
        cols = torch.arange(k0, k0 + block)
        kt, vt = _tile(k, k0, block), _tile(v, k0, block)
        acc_k, acc_v = torch.zeros(B, H, block, d), torch.zeros(B, H, block, d)
        first = (k0 // stream) * stream if causal else 0
        for q0 in range(first, T, stream):
            rows = torch.arange(q0, q0 + stream)
            qt, dot = _tile(q, q0, stream), _tile(do, q0, stream)
            lse_t, delta_t = _tile(lse, q0, stream), _tile(delta, q0, stream)
            s_t = mm(kt, qt.transpose(-1, -2)) * scale      # [keys, rows]
            dp_t = mm(vt, dot.transpose(-1, -2))
            p, ds = probs(s_t.transpose(-1, -2), dp_t.transpose(-1, -2),
                          rows, cols, lse_t, delta_t)
            acc_v = acc_v + mm_p(p.transpose(-1, -2), dot)
            acc_k = acc_k + mm_p(ds.transpose(-1, -2), qt)
        dk[:, :, k0:k0 + block] = (acc_k * scale)[:, :, :T - k0]
        dv[:, :, k0:k0 + block] = acc_v[:, :, :T - k0]
    return dq, dk, dv


def _design_case(masked, shape=(2, 2, 128, 32)):
    """q, k, v, dO of ``shape`` and an optional key mask (right padding and
    holes, key 0 valid in every row; two batch rows)."""
    rs = np.random.RandomState(40 + int(masked))
    q, k, v, do = (rs.randn(*shape).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        Bm, Tm = shape[0], shape[2]
        mask = np.ones((Bm, Tm), np.float32)
        mask[0, 100:] = 0                                 # right padding
        mask[1, 1 + rs.permutation(Tm - 1)[:40]] = 0      # holes; key 0 valid
    return q, k, v, do, mask


def _design_run(q, k, v, do, mask, mm, mm_p=None, **kw):
    """The emulated kernels on the plain forward's o and lse (as phase 6
    feeds them K1's), and the plain backward on the same inputs. ``mm_p``
    (default ``mm``) runs the products with P or dS on the left."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=True, mask=tm)
    got = _k3k4_emulated(tq, tk, tv, tdo, lse, fa.attention_delta(o, tdo),
                         causal=True, mask=tm, mm=mm,
                         mm_p=mm if mm_p is None else mm_p, **kw)
    plain = fa.flash_attention_backward_plain(tq, tk, tv, o, lse, tdo,
                                              causal=True, mask=tm)
    return got, plain


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("stream", [64, 32, 16],
                         ids=["stream64", "stream32", "stream16"])
def test_k3k4_tf32x3_design_meets_phase6_tolerance(stream, masked):
    """K3/K4's f32 design (three TF32 products per product, 64-row and
    64-key CTAs, 64-, 32- or 16-row streamed tiles) at [2, 2, 128, 32]
    causal, within chip_smoke phase 6's 1e-5·max|g| of the plain backward
    and of the JAX Pallas backward (interpret mode)."""
    q, k, v, do, mask = _design_case(masked)
    got, plain = _design_run(q, k, v, do, mask, _mm_tf32x3, stream=stream)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=True,
                                               mask=jm, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    for name, g, p, r in zip("qkv", got, plain, ref):
        assert torch.isfinite(g).all()
        assert _rel_err(g.numpy(), p.numpy()) <= 1e-5, f"d{name} vs plain"
        assert _rel_err(g.numpy(), r) <= 1e-5, f"d{name} vs JAX"


def test_k3k4_tf32x3_design_at_phase6_long_shape():
    """The same design at phase 6's long accumulation, T=2048 and d=128
    causal with 16-row streamed tiles (f32 at d=128), on one head: within
    1e-5·max|g| of the plain backward with five times to spare. It rounds
    every sum to nearest; the tensor core's truncating accumulation is what
    the kernels' per-tile sums (pv_f32_rn) keep out."""
    q, k, v, do, mask = _design_case(False, shape=(1, 1, 2048, 128))
    got, plain = _design_run(q, k, v, do, mask, _mm_tf32x3, stream=16)
    for name, g, p in zip("qkv", got, plain):
        assert _rel_err(g.numpy(), p.numpy()) <= 1e-5 / 5, f"d{name}"


def test_k3k4_single_tf32_product_misses_phase6_tolerance():
    """Why the kernels pay for three products: one TF32 product per
    product misses the 1e-5·max|g| band tenfold (TF32 keeps 2^-11), three
    stay five times inside it."""
    q, k, v, do, mask = _design_case(False)
    one, plain = _design_run(q, k, v, do, mask, _mm_tf32)
    three, _ = _design_run(q, k, v, do, mask, _mm_tf32x3)
    err_one = max(_rel_err(g.numpy(), p.numpy()) for g, p in zip(one, plain))
    err_three = max(_rel_err(g.numpy(), p.numpy())
                    for g, p in zip(three, plain))
    assert err_one > 10 * 1e-5 and 1e-5 > 5 * err_three


def test_k3k4_bf16_design_meets_phase6_tolerance():
    """K3/K4's bf16 design: bf16 operands, f32 accumulators, P and dS
    entering their products as two bf16 terms; the output rounded to bf16
    once. Within phase 6's 1e-2·max|g| of the plain bf16 backward."""
    q, k, v, do, _ = _design_case(False)
    qb, kb, vb, dob = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(qb, kb, vb, causal=True)
    got = _k3k4_emulated(qb.float(), kb.float(), vb.float(), dob.float(),
                         lse, fa.attention_delta(o, dob), causal=True,
                         mask=None, mm=torch.matmul, mm_p=_mm_bf16_split)
    plain = fa.flash_attention_backward_plain(qb, kb, vb, o, lse, dob,
                                              causal=True)
    for name, g, p in zip("qkv", got, plain):
        assert _rel_err(g.bfloat16().float().numpy(),
                        p.float().numpy()) <= 1e-2, f"d{name}"


def test_k3k4_bf16_one_rounding_leaves_little_room():
    """Why P and dS enter their bf16 products as two terms: one bf16
    rounding each stays inside phase 6's 1e-2·max|g| in the emulation, but
    at five times the two-term error and with under twice the room, where
    the card reads about twice the emulation's error."""
    q, k, v, do, _ = _design_case(False)
    qb, kb, vb, dob = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(qb, kb, vb, causal=True)
    plain = fa.flash_attention_backward_plain(qb, kb, vb, o, lse, dob,
                                              causal=True)

    def worst(mm_p):
        got = _k3k4_emulated(qb.float(), kb.float(), vb.float(), dob.float(),
                             lse, fa.attention_delta(o, dob), causal=True,
                             mask=None, mm=torch.matmul, mm_p=mm_p)
        return max(_rel_err(g.bfloat16().float().numpy(), p.float().numpy())
                   for g, p in zip(got, plain))

    two = worst(_mm_bf16_split)
    one = worst(lambda a, b: a.bfloat16().float() @ b)
    assert one > 5 * two and 1e-2 / 2 < one <= 1e-2


def test_bf16_plain_backward_keeps_dtype():
    q, k, v, do, _ = _inputs(33, False)
    qb, kb, vb, dob = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(qb, kb, vb, causal=True)
    got = fa.flash_attention_backward_plain(qb, kb, vb, o, lse, dob,
                                            causal=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    of, lsef = fa.flash_attention_plain(qb.float(), kb.float(), vb.float(),
                                        causal=True)
    ref = fa.flash_attention_backward_plain(qb.float(), kb.float(),
                                            vb.float(), of, lsef,
                                            dob.float(), causal=True)
    for g, r in zip(got, ref):
        assert _rel_err(g.float().numpy(), r.numpy()) <= 2e-2


@pytest.mark.parametrize("d", [8, 16], ids=["d8", "d16"])
def test_k3k4_design_at_small_head_dims(d):
    """K3/K4 at head dims 8 and 16: f32 as three TF32 products within
    phase 6's 1e-5·max|g| of the plain backward; f16 with exact products
    summed in f32, P and dS in two f16 terms and each gradient rounded once
    to f16, within phase 6's 2^-8·max|g| of the plain f16 backward."""
    q, k, v, do, mask = _design_case(True, shape=(2, 2, 128, d))
    got, plain = _design_run(q, k, v, do, mask, _mm_tf32x3)
    for name, g, p in zip("qkv", got, plain):
        assert _rel_err(g.numpy(), p.numpy()) <= 1e-5, f"d{name} f32"

    def mm_f16_terms(a, b):                       # lo first, then hi
        hi = a.half().float()
        return (a - hi).half().float() @ b + hi @ b

    h = [a.astype(np.float16).astype(np.float32) for a in (q, k, v, do)]
    got, _ = _design_run(*h, mask, torch.matmul, mm_p=mm_f16_terms)
    ref = _plain_grads(*(a.astype(np.float16) for a in (q, k, v, do)), mask,
                       True)
    for name, g, r in zip("qkv", got, ref):
        assert _rel_err(g.half().float().numpy(), r.float().numpy()) \
            <= 2.0 ** -8, f"d{name} f16"
