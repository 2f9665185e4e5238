"""Port parity: the plain version of the flash-attention kernel K1
(``deeplearning4j_torch/ops/flash_attention.py``) against the JAX package's
Pallas flash forward, run in interpret mode as its own tests run it, and
against the JAX ``scaled_dot_attention``.

Tolerance: atol 1e-5 on O and lse, f32. The two sides reduce the same sums
in different orders (XLA CPU vs PyTorch CPU matmuls); nothing else differs.
The CUDA kernel itself cannot run here: ``chip_smoke.py`` holds it against
this plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.conf.layers.attention import (  # noqa: E402
    scaled_dot_attention as jax_sdpa)
from deeplearning4j_tpu.ops.pallas_attention import (  # noqa: E402
    _flash_forward)
from deeplearning4j_torch.ops import flash_attention as fa  # noqa: E402

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


def test_supports():
    assert fa.supports((2, 8, 128, 32), mask=None)
    assert fa.supports((2, 8, 100, 64), mask=torch.ones(2, 100),
                       dtype=torch.bfloat16)
    assert not fa.supports((2, 8, 128, 48), mask=None)        # head dim
    assert not fa.supports((2, 8, 128, 32), mask=torch.ones(2, 8, 128))
    assert not fa.supports((2, 8, 128, 32), mask=None, dtype=torch.float64)
    assert not fa.supports((8, 128, 32), mask=None)
