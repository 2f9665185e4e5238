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
``2e-2·max|g|`` of the f32 computation on the same (rounded) inputs. The CUDA
kernels cannot run here: ``chip_smoke.py`` holds them against this plain
version on the card.
"""

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
