"""Port parity at the head dims the kernels take since ROADMAP B3 (a) and
(b): 128 < d <= 256 (run at the wide widths 160, 192, 224 and 256) and d
that is not a multiple of 4 (d = 1..3 included), on the CPU.

- The plain versions of K1/K3/K4 (``ops/flash_attention.py``) against the
  JAX package's Pallas flash forward and ``jax.vjp`` through it (interpret
  mode) at d = 2, 6, 50, 130, 192 and 256, causal with a key mask: f32
  within atol 1e-5 (O, lse) and 1e-5·max|g| (gradients); f16 within one
  f16 step of max|O| (2^-10·max|O|) and two of max|g| (2^-9), both sides
  computing in f32 and rounding once (the tolerances of
  ``test_torch_head_dims.py``).
- The plain K2 (``paged_attention_plain``) against JAX's
  ``XlaPagedAttention`` at the same head dims and ``PallasPagedAttention``
  (interpret mode) at d = 192 and 256 (the JAX kernel takes d % 64 == 0),
  f32 and int8 pools, a decode row and a chunk that crosses a page
  boundary, within atol 1e-5.
- A JAX ``TransformerLM(d_model=512, n_heads=2)`` (two heads of d = 256,
  the head dim of GPT-J-6B) carried over with ``params_from_jax`` and
  served greedy by the port's ``GenerationServer``: streams equal the JAX
  server's, f32 and int8 KV.
- The wide kernels' f32 design rehearsed in torch: K1 and K4 with the
  output's columns split over two CTAs, each forming the scores over the
  full width with three TF32 products per product (``kernels/common.cuh``:
  K1 over 32-key tiles, K4 over 16-row q tiles), at d = 256 and at d = 130
  zero-padded to the width 160 it runs at: within phase 2's atol 1e-4 and
  phase 6's 1e-5·max|g| of the plain versions.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` phases
2, 3 and 6 hold them against these plain versions at these head dims, and
phase 21 runs them at GPT-J-6B's attention width.
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
from test_torch_flash_backward import _masked, _tile  # noqa: E402
from test_torch_head_dims import (  # noqa: E402
    _flash_inputs, _paged_case, _rel_err)
from tf32_emulation import _mm_tf32x3  # noqa: E402

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIMS = [2, 6, 50, 130, 192, 256]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_widths_cover_every_head_dim_to_256():
    """Every d in 1..256 runs at a width d <= w < d + 32 (8 for d <= 8),
    the decode route at the next power of two; 256 is exact; past 256
    nothing."""
    for d in range(1, 257):
        w = kernels.kernel_width(d)
        assert w in kernels.KERNEL_WIDTHS and d <= w < max(d + 32, 9)
        p = kernels.decode_width(d)
        assert p in kernels.EXACT_HEAD_DIMS and d <= p
        assert p == 8 or p < 2 * d
    assert kernels.kernel_width(256) == kernels.decode_width(256) == 256
    assert 256 in kernels.EXACT_HEAD_DIMS
    for d in (0, 257, 512):
        assert kernels.kernel_width(d) is None
        assert kernels.decode_width(d) is None
    assert "1..256" in kernels.HEAD_DIM_RULE


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", ["float32", "float16"], ids=["f32", "f16"])
def test_plain_flash_forward_matches_jax(d, dtype):
    q, k, v, _, mask = _flash_inputs(d, dtype, 500 + d)
    T = q.shape[2]
    jo, jlse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), causal=True, block_q=T,
                              block_k=T, interpret=True)
    o, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, mask=torch.from_numpy(mask))
    jo = np.asarray(jo).astype(np.float32)
    assert o.dtype == getattr(torch, dtype) and o.shape == q.shape
    atol = 1e-5 if dtype == "float32" else 2.0 ** -10 * np.abs(jo).max()
    np.testing.assert_allclose(o.float().numpy(), jo, atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", ["float32", "float16"], ids=["f32", "f16"])
def test_plain_flash_backward_matches_jax(d, dtype):
    q, k, v, do, mask = _flash_inputs(d, dtype, 600 + d)
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
        assert g.dtype == getattr(torch, dtype) and g.shape == q.shape
        assert _rel_err(g.float().numpy(), np.asarray(r).astype(
            np.float32)) <= tol, f"d{name}"


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T_q", [1, 6], ids=["decode", "chunk"])
def test_plain_paged_matches_jax_backends(d, quant, T_q):
    q, pool, bt, pos, mask = _paged_case(d, quant, T_q, 700 + d + T_q)
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
    if d % 64 == 0:
        np.testing.assert_allclose(
            got, jx(jppa.PallasPagedAttention(interpret=True)), atol=1e-5,
            rtol=0)


# ------------------------------------------------------ the d = 256 model
V = 17
CAP = 64
SHAPES = [(3, 6), (5, 4), (9, 5), (3, 5), (5, 6), (9, 4)]


@pytest.fixture(scope="module")
def d256_pair():
    """A JAX ``TransformerLM`` of two heads of d = 256 and the port's twin
    holding its weights."""
    cfg = dict(num_labels=V, max_length=16, d_model=512, n_heads=2,
               n_blocks=1)
    jnet = jzoo.TransformerLM(seed=5, **cfg).init()
    for _, layer in jnet._stream_layers():
        if hasattr(layer, "max_cache"):
            layer.max_cache = CAP
    tnet = zoo.TransformerLM(max_cache=CAP, **cfg).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32kv", "int8kv"])
def test_d256_model_serves_like_jax(d256_pair, kv):
    jnet, tnet = d256_pair
    assert kernels.kernel_width(512 // 2) == 256
    rs = np.random.RandomState(6)
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


# -------------------------------------- the wide kernels' design, rehearsed
def _wide_case(d, T=128, seed=0):
    """q, k, v, dO [1, 2, T, d] and a key mask (right padding, holes; key 0
    valid)."""
    rs = np.random.RandomState(900 + d + seed)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 2, T, d).astype(np.float32))
                   for _ in range(4))
    mask = torch.ones(1, T)
    mask[0, 100:] = 0
    mask[0, 1 + torch.from_numpy(rs.permutation(T - 1)[:30])] = 0
    return q, k, v, do, mask


def _pad(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _k1_halves(q, k, v, *, mask, width, block_m=64, block_n=32):
    """K1's walk past a width of 128 (``kernels/flash_fwd.cuh``) in f32:
    q, k, v zero-padded to ``width``; per 64-row q tile two CTAs, each
    forming S = q·kᵀ over the full width (three TF32 products, scaled by
    1/√d of the true d) tile by tile over ``block_n`` keys up to the causal
    limit, and accumulating its half of O's columns; lse from half 0.
    Returns (o [.., d], lse)."""
    B, H, T, d = q.shape
    qp, kp, vp = (_pad(t, width) for t in (q, k, v))
    half = width // 2
    scale = 1.0 / math.sqrt(d)
    o = torch.empty(B, H, T, width)
    lse = torch.empty(B, H, T, 1)
    for q0 in range(0, T, block_m):
        rows = torch.arange(q0, q0 + block_m)
        qt = _tile(qp, q0, block_m)
        for h in range(2):
            m = torch.full((B, H, block_m, 1), -1e30)
            l = torch.zeros(B, H, block_m, 1)
            acc = torch.zeros(B, H, block_m, half)
            for k0 in range(0, min(T, q0 + block_m), block_n):
                cols = torch.arange(k0, k0 + block_n)
                kt = _tile(kp, k0, block_n)
                vt = _tile(vp, k0, block_n)[..., h * half:(h + 1) * half]
                s = _mm_tf32x3(qt, kt.transpose(-1, -2)) * scale
                s = torch.where(_masked(rows, cols, T, True, mask),
                                torch.full_like(s, -1e30), s)
                s = torch.where(cols >= T, torch.full_like(s, -math.inf), s)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha, p = torch.exp(m - mx), torch.exp(s - mx)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + _mm_tf32x3(p, vt)
                m = mx
            lc = l.clamp_min(1e-30)
            n = min(block_m, T - q0)
            o[:, :, q0:q0 + n, h * half:(h + 1) * half] = (acc / lc)[:, :, :n]
            if h == 0:
                lse[:, :, q0:q0 + n] = (m + torch.log(lc))[:, :, :n]
    return o[..., :d], lse.reshape(B * H, T, 1)


def _k4_halves(q, k, v, do, lse, delta, *, mask, width, block=64,
               stream=16):
    """K4's walk past a width of 128 (``kernels/flash_bwd.cuh``) in f32:
    per 64-key tile two CTAs over ``stream``-row q/dO tiles from the tile
    holding the first key, each forming Sᵀ = K·qᵀ and dPᵀ = V·dOᵀ over the
    full (zero-padded) width and accumulating its half of dK and dV's
    columns, each tile's sum added by f32 adds (three TF32 products per
    product). Returns (dk, dv) [.., d]."""
    B, H, T, d = q.shape
    qp, kp, vp, dop = (_pad(t, width) for t in (q, k, v, do))
    half = width // 2
    scale = 1.0 / math.sqrt(d)
    lse, delta = lse.reshape(B, H, T, 1), delta.reshape(B, H, T, 1)
    dk, dv = torch.zeros(B, H, T, width), torch.zeros(B, H, T, width)
    for k0 in range(0, T, block):
        cols = torch.arange(k0, k0 + block)
        kt, vt = _tile(kp, k0, block), _tile(vp, k0, block)
        for h in range(2):
            sl = slice(h * half, (h + 1) * half)
            acc_k = torch.zeros(B, H, block, half)
            acc_v = torch.zeros(B, H, block, half)
            for q0 in range((k0 // stream) * stream, T, stream):
                rows = torch.arange(q0, q0 + stream)
                qt, dot = _tile(qp, q0, stream), _tile(dop, q0, stream)
                lse_t, delta_t = _tile(lse, q0, stream), _tile(delta, q0,
                                                               stream)
                s = _mm_tf32x3(kt, qt.transpose(-1, -2)).transpose(-1, -2)
                dp = _mm_tf32x3(vt, dot.transpose(-1, -2)).transpose(-1, -2)
                s = torch.where(_masked(rows, cols, T, True, mask),
                                torch.full_like(s, -1e30), s * scale)
                p = torch.exp(s - lse_t)
                p = torch.where((rows[:, None] >= T) | (cols[None, :] >= T),
                                torch.zeros_like(p), p)
                ds = p * (dp - delta_t)
                acc_v = acc_v + _mm_tf32x3(p.transpose(-1, -2), dot[..., sl])
                acc_k = acc_k + _mm_tf32x3(ds.transpose(-1, -2), qt[..., sl])
            n = min(block, T - k0)
            dk[:, :, k0:k0 + n, sl] = (acc_k * scale)[:, :, :n]
            dv[:, :, k0:k0 + n, sl] = acc_v[:, :, :n]
    return dk[..., :d], dv[..., :d]


@pytest.mark.parametrize("d", [256, 130])
def test_wide_k1_k4_design_meets_phase_tolerances(d):
    """K1 and K4 with the output's columns split over two CTAs (the wide
    widths' design) at d = 256 (exact) and d = 130 (padded to 160), causal
    under a key mask: K1 within phase 2's atol 1e-4 of the plain forward,
    K4 within phase 6's 1e-5·max|g| of the plain backward; the padded
    columns stay exact zeros."""
    width = kernels.kernel_width(d)
    assert width == {256: 256, 130: 160}[d]
    q, k, v, do, mask = _wide_case(d)
    po, plse = fa.flash_attention_plain(q, k, v, causal=True, mask=mask)
    o, lse = _k1_halves(q, k, v, mask=mask, width=width)
    np.testing.assert_allclose(o.numpy(), po.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), atol=1e-4, rtol=0)
    _, pdk, pdv = fa.flash_attention_backward_plain(q, k, v, po, plse, do,
                                                    causal=True, mask=mask)
    dk, dv = _k4_halves(q, k, v, do, plse, fa.attention_delta(po, do),
                        mask=mask, width=width)
    assert _rel_err(dk.numpy(), pdk.numpy()) <= 1e-5
    assert _rel_err(dv.numpy(), pdv.numpy()) <= 1e-5
