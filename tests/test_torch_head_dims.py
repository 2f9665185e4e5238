"""Port parity at the head dims the kernels take padded (ROADMAP B3): every
d with 4 <= d <= 128 and d % 4 == 0, on the CPU.

- The plain versions of K1/K3/K4 (``ops/flash_attention.py``) against the
  JAX package's Pallas flash forward and ``jax.vjp`` through it (interpret
  mode) at d = 4, 12, 48 and 96, causal with a key mask: f32 within atol
  1e-5 (O, lse) and 1e-5·max|g| (gradients); f16 within one f16 step of
  max|O| (2^-10·max|O|) and two of max|g| (2^-9), both sides computing in
  f32 and rounding once.
- The plain K2 (``paged_attention_plain``) against JAX's
  ``XlaPagedAttention`` and ``PallasPagedAttention`` (interpret mode) at
  d = 4, 48 and 96, f32 and int8 pools, a decode row and a chunk that
  crosses a page boundary, within atol 1e-5.
- A JAX ``TransformerLM(d_model=96, n_heads=2)`` (two heads of d = 48)
  carried over with ``params_from_jax`` and served greedy by the port's
  ``GenerationServer``: streams equal the JAX server's, f32 and int8 KV.
- The padded kernels' f32 arithmetic, rehearsed in torch: K1's tile walk
  with three TF32 products per product (``test_torch_flash_attention.py``)
  on q, k, v zero-padded from d = 36 to the width 48 it runs at, scaled by
  1/√36, within phase 2's atol 1e-4 of the plain version at d = 36; scaled
  by the padded width's 1/√48 instead, it leaves that band by far (the
  slip a kernel test at d ≠ D_pad has to catch).

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` phases
2, 3 and 6 hold them against these plain versions at the new widths.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    paged_attention as jppa)
from deeplearning4j_tpu.ops.pallas_attention import (  # noqa: E402
    _flash_forward, flash_attention as jax_flash)
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_torch import kernels  # noqa: E402
from deeplearning4j_torch.models import zoo  # noqa: E402
from deeplearning4j_torch.nn.conf.layers import (  # noqa: E402
    paged_attention as ppa)
from deeplearning4j_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402
from test_torch_flash_attention import _k1_emulated  # noqa: E402
from tf32_emulation import _mm_tf32x3  # noqa: E402

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, T = 2, 2, 16


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _flash_inputs(d, dtype, seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, H, T, d).astype(dtype) for _ in range(4))
    mask = np.ones((B, T), np.float32)
    mask[0, 11:] = 0                              # right padding
    mask[1, 1 + rs.permutation(T - 1)[:5]] = 0    # holes; key 0 valid
    return q, k, v, do, mask


@pytest.mark.parametrize("d", [4, 12, 48, 96])
@pytest.mark.parametrize("dtype", ["float32", "float16"], ids=["f32", "f16"])
def test_plain_flash_forward_matches_jax(d, dtype):
    q, k, v, _, mask = _flash_inputs(d, dtype, 100 + d)
    jo, jlse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), causal=True, block_q=T,
                              block_k=T, interpret=True)
    o, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, mask=torch.from_numpy(mask))
    jo = np.asarray(jo).astype(np.float32)
    assert o.dtype == getattr(torch, dtype) and o.shape == (B, H, T, d)
    atol = 1e-5 if dtype == "float32" else 2.0 ** -10 * np.abs(jo).max()
    np.testing.assert_allclose(o.float().numpy(), jo, atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("d", [4, 12, 48, 96])
@pytest.mark.parametrize("dtype", ["float32", "float16"], ids=["f32", "f16"])
def test_plain_flash_backward_matches_jax(d, dtype):
    q, k, v, do, mask = _flash_inputs(d, dtype, 200 + d)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=True,
                                               mask=jm, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tm = torch.from_numpy(mask)
    o, lse = fa.flash_attention_plain(*t[:3], causal=True, mask=tm)
    got = fa.flash_attention_backward_plain(*t[:3], o, lse, t[3],
                                            causal=True, mask=tm)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -9
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == getattr(torch, dtype) and g.shape == (B, H, T, d)
        assert _rel_err(g.float().numpy(), np.asarray(r).astype(
            np.float32)) <= tol, f"d{name}"


PS, NP = 8, 4                     # Tmax = 32


def _paged_case(d, quant, T_q, seed):
    rs = np.random.RandomState(seed)
    Bp = 3
    pages = Bp * NP + 1
    if quant:
        pool = {"kpages": rs.randint(-127, 128, (pages, H, PS, d)).astype(
                    np.int8),
                "vpages": rs.randint(-127, 128, (pages, H, PS, d)).astype(
                    np.int8),
                "kscales": (rs.rand(pages, H, PS) * 0.05).astype(np.float32),
                "vscales": (rs.rand(pages, H, PS) * 0.05).astype(np.float32)}
    else:
        pool = {"kpages": rs.randn(pages, H, PS, d).astype(np.float32),
                "vpages": rs.randn(pages, H, PS, d).astype(np.float32)}
    bt = (rs.permutation(pages - 1)[:Bp * NP] + 1).reshape(Bp, NP).astype(
        np.int32)
    if T_q == 1:
        pos = rs.randint(0, NP * PS, Bp).astype(np.int32)
        mask = None
    else:                         # crosses a page boundary, right padding
        pos = np.array([5, 13, 2], np.int32)
        mask = np.ones((Bp, T_q), np.float32)
        mask[0, T_q - 2:] = 0
    q = rs.randn(Bp, H, T_q, d).astype(np.float32)
    return q, pool, bt, pos, mask


@pytest.mark.parametrize("d", [4, 48, 96])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T_q", [1, 6], ids=["decode", "chunk"])
def test_plain_paged_matches_jax_backends(d, quant, T_q):
    q, pool, bt, pos, mask = _paged_case(d, quant, T_q, 300 + d + T_q)
    ks, vs = pool.get("kscales"), pool.get("vscales")

    def jx(helper):
        return np.asarray(helper.attend(
            jnp.asarray(q), jnp.asarray(pool["kpages"]),
            jnp.asarray(pool["vpages"]), jnp.asarray(bt), jnp.asarray(pos),
            mask=None if mask is None else jnp.asarray(mask),
            kscales=None if ks is None else jnp.asarray(ks),
            vscales=None if vs is None else jnp.asarray(vs)))

    t = {k: torch.from_numpy(v) for k, v in pool.items()}
    got = ppa.paged_attend(
        "pallas", torch.from_numpy(q), t["kpages"], t["vpages"],
        torch.from_numpy(bt), torch.from_numpy(pos),
        mask=None if mask is None else torch.from_numpy(mask),
        kscales=t.get("kscales"), vscales=t.get("vscales")).numpy()
    assert got.shape == q.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, jx(jppa.XlaPagedAttention()), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(
        got, jx(jppa.PallasPagedAttention(interpret=True)), atol=1e-5,
        rtol=0)


V = 17
CAP = 64
SHAPES = [(3, 6), (5, 4), (9, 5), (3, 5), (5, 6), (9, 4)]


@pytest.fixture(scope="module")
def d48_pair():
    """A JAX ``TransformerLM`` of two heads of d = 48 and the port's twin
    holding its weights."""
    cfg = dict(num_labels=V, max_length=16, d_model=96, n_heads=2,
               n_blocks=1)
    jnet = jzoo.TransformerLM(seed=3, **cfg).init()
    for _, layer in jnet._stream_layers():
        if hasattr(layer, "max_cache"):
            layer.max_cache = CAP
    tnet = zoo.TransformerLM(max_cache=CAP, **cfg).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32kv", "int8kv"])
def test_d48_model_serves_like_jax(d48_pair, kv):
    jnet, tnet = d48_pair
    assert kernels.kernel_width(96 // 2) == 48
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, V, p), s) for p, s in SHAPES]
    kw = dict(slots=3, page_size=8, kv_dtype=kv)
    outs = []
    for srv in (GenerationServer(tnet, V, device="cpu", **kw),
                JaxGenerationServer(jnet, V, paged_attention="xla", **kw)):
        try:
            futs = [srv.submit(p, s) for p, s in reqs]
            outs.append([f.result(timeout=180).tolist() for f in futs])
        finally:
            srv.close()
    assert outs[0] == outs[1]
    assert len({t for o in outs[0] for t in o}) > 2


def test_padded_k1_design_scales_by_the_true_head_dim():
    """K1's f32 tile walk on q, k, v of d = 36 zero-padded to the width 48
    it runs at: with the scale 1/√36 within phase 2's atol 1e-4 of the
    plain version at d = 36 (the zero columns add exact zeros to every
    product), with 1/√48 far outside it."""
    d, width = 36, kernels.kernel_width(36)
    assert width == 48
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.randn(2, 2, 128, d).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(2, 128)
    mask[0, 100:] = 0
    pad = [torch.nn.functional.pad(t, (0, width - d)) for t in (q, k, v)]
    po, plse = fa.flash_attention_plain(q, k, v, causal=True, mask=mask)
    o, lse = _k1_emulated(*pad, causal=True, mask=mask, mm=_mm_tf32x3,
                          scale=1.0 / math.sqrt(d))
    assert torch.equal(o[..., d:], torch.zeros_like(o[..., d:]))
    np.testing.assert_allclose(o[..., :d].numpy(), po.numpy(), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), atol=1e-4, rtol=0)
    wrong, _ = _k1_emulated(*pad, causal=True, mask=mask, mm=_mm_tf32x3,
                            scale=1.0 / math.sqrt(width))
    assert (wrong[..., :d] - po).abs().max().item() > 1e-2
