"""Port parity: the plain version of the paged-attention kernel K2
(``deeplearning4j_torch/nn/conf/layers/paged_attention.py``) against the JAX
package's ``XlaPagedAttention`` and ``PallasPagedAttention`` (interpret mode),
over f32 and int8 pools and the geometries a block-table walk can get wrong:
decode at T=1, a chunk straddling two pages, positions exactly on a page
boundary, and an all-masked chunk routed to garbage page 0. Also the int8
codes of ``_quantize_kv`` and the pool contents after ``_paged_forward``'s
write.

Tolerance: atol 1e-5 on the context (f32; sums reduce in another order on
the two sides). Quantization codes and written pools must be equal exactly:
the write test uses identity K/V projections, so both sides quantize the
same f32 values. The CUDA kernel is held against this plain version on the
card by ``chip_smoke.py``.

The kernel's decode-route design is rehearsed here in torch: the walked
pages cut into 8 contiguous ranges (one per warp), a partial (m, l, acc)
per range with m starting at -1e30, and the partials merged in fixed range
order, as ``kernels/paged_attn.cu`` does. It must match the plain version
and the JAX ``XlaPagedAttention`` on every row that sees a column, empty
ranges and all.

So is its chunk-route design (T > 4): 64-row q tiles of 16-row warps over
64-key tiles whose rows resolve through the block table (a tile crosses
pages), q pre-scaled by log2(e)/√d and the softmax in base 2, f32 products
as three TF32 products of hi/lo splits (``tf32_emulation.py``), int8 as the
exact products with the codes (the kernel splits q and P·vscale in three
TF32 parts) and the scales applied outside, P·V summed per tile, and the
walk cut into contiguous ranges merged in fixed order (the small-T split). It must match the plain version, the JAX
``XlaPagedAttention`` and ``PallasPagedAttention`` (interpret mode) within
atol 1e-5 on every row that sees a column, at the small geometries above
and at two ragged q tiles (T=100, d=32).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    paged_attention as jppa)
from deeplearning4j_tpu.nn.conf.layers.attention import (  # noqa: E402
    SelfAttentionLayer as JaxSelfAttention)
from deeplearning4j_torch.nn.conf.layers import (  # noqa: E402
    paged_attention as ppa)
from deeplearning4j_torch.nn.conf.layers.attention import (  # noqa: E402
    SelfAttentionLayer)
from tf32_emulation import _mm_tf32x3  # noqa: E402

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, D, PS, NP = 4, 8, 8, 4          # Tmax = 32
CASES = ["decode", "straddle", "boundary", "masked_to_page0"]


def _pool(rs, pages, quant, h=H, ps=PS, d=D):
    if quant:
        return {"kpages": rs.randint(-127, 128, (pages, h, ps, d)).astype(
                    np.int8),
                "vpages": rs.randint(-127, 128, (pages, h, ps, d)).astype(
                    np.int8),
                "kscales": (rs.rand(pages, h, ps) * 0.05).astype(np.float32),
                "vscales": (rs.rand(pages, h, ps) * 0.05).astype(np.float32)}
    return {"kpages": rs.randn(pages, h, ps, d).astype(np.float32),
            "vpages": rs.randn(pages, h, ps, d).astype(np.float32)}


def _case(name, quant):
    """(q, pool, bt, pos, mask) numpy inputs for one edge geometry."""
    rs = np.random.RandomState(CASES.index(name) * 2 + int(quant))
    B = 3
    pages = B * NP + 1
    pool = _pool(rs, pages, quant)
    bt = (rs.permutation(pages - 1)[:B * NP] + 1).reshape(B, NP).astype(
        np.int32)
    mask = None
    if name == "decode":
        T, pos = 1, rs.randint(0, NP * PS, B).astype(np.int32)
    elif name == "straddle":
        T, pos = 6, np.array([5, 13, 2], np.int32)     # crosses a boundary
    elif name == "boundary":
        T, pos = 1, np.array([0, PS, 2 * PS], np.int32)
    else:                                              # "masked_to_page0"
        T, pos = 8, np.array([3, 0, 9], np.int32)
        mask = np.ones((B, T), np.float32)
        mask[0, 5:] = 0                                # right padding
        mask[1, :] = 0                                 # all masked ...
        bt[1, :] = 0                                   # ... on page 0
    q = rs.randn(B, H, T, D).astype(np.float32)
    return q, pool, bt, pos, mask


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_backends(name, quant):
    q, pool, bt, pos, mask = _case(name, quant)
    ks = pool.get("kscales")
    vs = pool.get("vscales")

    def jx(helper):
        return np.asarray(helper.attend(
            jnp.asarray(q), jnp.asarray(pool["kpages"]),
            jnp.asarray(pool["vpages"]), jnp.asarray(bt), jnp.asarray(pos),
            mask=None if mask is None else jnp.asarray(mask),
            kscales=None if ks is None else jnp.asarray(ks),
            vscales=None if vs is None else jnp.asarray(vs)))

    ref_xla = jx(jppa.XlaPagedAttention())
    ref_pallas = jx(jppa.PallasPagedAttention(interpret=True))
    t = {k: torch.from_numpy(v) for k, v in pool.items()}
    got = ppa.paged_attend(
        "xla", torch.from_numpy(q), t["kpages"], t["vpages"],
        torch.from_numpy(bt), torch.from_numpy(pos),
        mask=None if mask is None else torch.from_numpy(mask),
        kscales=t.get("kscales"), vscales=t.get("vscales")).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref_xla, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref_pallas, atol=1e-5, rtol=0)
    # the kernel's wrapper on CPU tensors is the same plain version
    wrapped = ppa.paged_attend(
        "pallas", torch.from_numpy(q), t["kpages"], t["vpages"],
        torch.from_numpy(bt), torch.from_numpy(pos),
        mask=None if mask is None else torch.from_numpy(mask),
        kscales=t.get("kscales"), vscales=t.get("vscales")).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_key_valid_plane_matches_jax():
    rs = np.random.RandomState(3)
    mask = (rs.rand(3, 6) > 0.3).astype(np.float32)
    pos = np.array([0, 5, 26], np.int32)
    ref = np.asarray(jppa._key_valid_plane(jnp.asarray(mask),
                                           jnp.asarray(pos), 6, 32))
    got = ppa._key_valid_plane(torch.from_numpy(mask), torch.from_numpy(pos),
                               6, 32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_quantize_kv_codes_equal_jax():
    rs = np.random.RandomState(4)
    t = (rs.randn(3, H, 7, D) * rs.rand(3, H, 7, 1) * 4).astype(np.float32)
    t[0, 1, 2] = 0.0                               # all-zero row: scale 0
    t[1, 0, 0, :2] = [127 * 0.5, -127 * 0.5]       # exact half-steps
    jq, jsc = JaxSelfAttention._quantize_kv(jnp.asarray(t))
    q, sc = SelfAttentionLayer._quantize_kv(torch.from_numpy(t))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert sc[0, 1, 2] == 0 and (q[0, 1, 2] == 0).all()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_paged_forward_output_and_pool_write(quant, masked):
    """One ``_paged_forward`` chunk through both layers: the output within
    atol 1e-5, the written pool (values and scale planes) equal exactly."""
    rs = np.random.RandomState(10 + 2 * quant + masked)
    B, T, F = 3, 6, H * D
    kw = dict(n_in=F, n_out=F, n_heads=H, causal=True, max_cache=NP * PS,
              bias_init=0.0)
    jl = JaxSelfAttention(paged_attention="xla", **kw)
    tl = SelfAttentionLayer(**kw)
    tl.finalize()
    params = {k: np.array(v) for k, v in
              jl.init_params(jax.random.PRNGKey(0)).items()}
    # identity K/V projections: both sides quantize the same f32 values
    params["Wk"] = np.eye(F, dtype=np.float32)
    params["Wv"] = np.eye(F, dtype=np.float32)
    params["b"] = (0.1 * rs.randn(F)).astype(np.float32)
    pages = B * NP + 1
    pool = _pool(rs, pages, quant)
    bt = (rs.permutation(pages - 1)[:B * NP] + 1).reshape(B, NP).astype(
        np.int32)
    pos = np.array([0, 7, 20], np.int32)
    x = rs.randn(B, T, F).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 4:] = 0
        mask[2, 1:] = 0
    jstate = {k: jnp.asarray(v) for k, v in pool.items()}
    jstate.update(block_table=jnp.asarray(bt), cache_pos=jnp.asarray(pos))
    jout, jst = jl.forward({k: jnp.asarray(v) for k, v in params.items()},
                           jstate, jnp.asarray(x),
                           mask=None if mask is None else jnp.asarray(mask))
    tstate = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tstate.update(block_table=torch.from_numpy(bt),
                  cache_pos=torch.from_numpy(pos))
    tout, tst = tl.forward({k: torch.from_numpy(v) for k, v in params.items()},
                           tstate, torch.from_numpy(x),
                           mask=None if mask is None else torch.from_numpy(
                               mask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    # page 0 is the garbage sink: colliding masked writes may land there in
    # either order, so only the real pages must agree
    for key in pool:
        np.testing.assert_array_equal(tst[key].numpy()[1:],
                                      np.asarray(jst[key])[1:], err_msg=key)
    np.testing.assert_array_equal(tst["cache_pos"].numpy(),
                                  np.asarray(jst["cache_pos"]))
    # the write went into the pool tensors in place
    assert tst["kpages"] is tstate["kpages"]


def test_resolve_paged_backend():
    assert ppa.resolve_paged_backend("auto", "cpu") == "xla"
    assert ppa.resolve_paged_backend("auto", "cuda") == "pallas"
    assert ppa.resolve_paged_backend("pallas", "cpu") == "pallas"
    assert ppa.resolve_paged_backend("stock", "cuda") == "xla"
    assert ppa.resolve_paged_backend("xla", "cuda") == "xla"
    with pytest.raises(ValueError, match="unknown paged_attention"):
        ppa.resolve_paged_backend("cudnn", "cuda")


# ------------------------------------------- K2's decode design, rehearsed
def _k2_split_walk(q, kp, vp, bt, pos, *, key_valid=None, kscales=None,
                   vscales=None, warps=8):
    """K2's decode route in f32: the walked columns [0, min(Tmax, pos + T))
    as ``warps`` contiguous page ranges, each folded into its own (m, l,
    acc) (m from -1e30, masked columns -1e30), then merged in range order.
    Returns (context, number of empty ranges)."""
    B, H, T, d = q.shape
    ps, NP = kp.shape[2], bt.shape[1]
    Tmax = NP * ps
    qs = q * (1.0 / math.sqrt(d))
    out = torch.empty_like(q)
    empty = 0
    for b in range(B):
        kend = min(Tmax, int(pos[b]) + T)
        npages = -(-kend // ps)
        per = -(-npages // warps)
        parts = []
        for w in range(warps):
            pb = min(npages, w * per)
            pe = min(npages, pb + per)
            if pb == pe:
                empty += 1
                parts.append((torch.full((H, T, 1), -1e30),
                              torch.zeros(H, T, 1), torch.zeros(H, T, d)))
                continue
            cols = torch.arange(pb * ps, min(kend, pe * ps))
            pages, offs = bt[b, cols // ps].long(), cols % ps
            kk = kp[pages, :, offs].float()             # [n, H, d]
            vv = vp[pages, :, offs].float()
            if kscales is not None:
                kk = kk * kscales[pages, :, offs][..., None]
                vv = vv * vscales[pages, :, offs][..., None]
            s = qs[b] @ kk.permute(1, 2, 0)              # [H, T, n]
            ok = cols[None, :] <= int(pos[b]) + torch.arange(T)[:, None]
            if key_valid is not None:
                ok = ok & (key_valid[b, cols] != 0)[None, :]
            s = torch.where(ok, s, torch.full_like(s, -1e30))
            m = s.amax(-1, keepdim=True).clamp_min(-1e30)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True), p @ vv.permute(1, 0, 2)))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = torch.zeros(H, T, 1)
        acc = torch.zeros(H, T, d)
        for m, l, a in parts:                            # fixed range order
            e = torch.exp(m - mx)
            lsum = lsum + l * e
            acc = acc + a * e
        out[b] = acc / lsum.clamp_min(1e-30)
    return out, empty


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_k2_split_walk_design_matches_plain_and_jax(name, quant):
    """Every case geometry (decode, a chunk straddling a page, positions on
    a page boundary, an all-masked row on garbage page 0) with at most 4
    walked pages over 8 ranges, so empty ranges always occur."""
    q, pool, bt, pos, mask = _case(name, quant)
    T = q.shape[2]
    t = {k: torch.from_numpy(v) for k, v in pool.items()}
    tq, tbt, tpos = (torch.from_numpy(a) for a in (q, bt, pos))
    key_valid = None
    if mask is not None:
        key_valid = ppa._key_valid_plane(torch.from_numpy(mask), tpos, T,
                                         NP * PS)
    kw = dict(kscales=t.get("kscales"), vscales=t.get("vscales"))
    got, empty = _k2_split_walk(tq, t["kpages"], t["vpages"], tbt, tpos,
                                key_valid=key_valid, **kw)
    plain = ppa.paged_attention_plain(tq, t["kpages"], t["vpages"], tbt,
                                      tpos, key_valid=key_valid, **kw)
    jax_ref = np.asarray(jppa.XlaPagedAttention().attend(
        jnp.asarray(q), jnp.asarray(pool["kpages"]),
        jnp.asarray(pool["vpages"]), jnp.asarray(bt), jnp.asarray(pos),
        mask=None if mask is None else jnp.asarray(mask),
        kscales=None if "kscales" not in pool else jnp.asarray(
            pool["kscales"]),
        vscales=None if "vscales" not in pool else jnp.asarray(
            pool["vscales"])))
    assert empty > 0 and torch.isfinite(got).all()
    # rows that see no column at all (the all-masked row) are uniform over
    # the columns the walk covers, as in the kernel: finite, not compared
    col = torch.arange(NP * PS)
    vis = col[None, None] <= tpos.long()[:, None, None] + torch.arange(T)[
        None, :, None]
    if key_valid is not None:
        vis = vis & (key_valid[:, None] != 0)
    seen = vis.any(-1)[:, None, :, None].expand_as(got).numpy()
    np.testing.assert_allclose(np.where(seen, got.numpy(), 0),
                               np.where(seen, plain.numpy(), 0),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.where(seen, got.numpy(), 0),
                               np.where(seen, jax_ref, 0), atol=1e-5, rtol=0)


def test_k2_split_walk_is_order_fixed():
    """Two runs of the split walk are bitwise equal, and an empty range
    adds exactly nothing: the same row over 1 range and over 8 agrees."""
    q, pool, bt, pos, _ = _case("decode", False)
    t = {k: torch.from_numpy(v) for k, v in pool.items()}
    args = (torch.from_numpy(q), t["kpages"], t["vpages"],
            torch.from_numpy(bt), torch.from_numpy(pos))
    a, _ = _k2_split_walk(*args)
    b, _ = _k2_split_walk(*args)
    one, empty_one = _k2_split_walk(*args, warps=1)
    assert torch.equal(a, b) and empty_one == 0
    np.testing.assert_allclose(a.numpy(), one.numpy(), atol=1e-6, rtol=0)


# -------------------------------------------- K2's chunk design, rehearsed
LOG2E = 1.4426950408889634


def _k2_chunk_walk(q, kp, vp, bt, pos, *, key_valid=None, kscales=None,
                   vscales=None, splits=1):
    """K2's chunk route in f32 arithmetic. Per 64-row q tile the causal
    walk [0, kend), kend = min(Tmax, pos + the tile's last row + 1), in
    64-key tiles (32 at d=128) cut into ``splits`` contiguous ranges of
    whole tiles. Per 16-row warp and range: an online softmax in base 2
    from m = -1e30 over the range's tiles (a tile wholly past the warp's
    rows causally is skipped), with key-valid and causal masks at -1e30
    and columns past the walk at -inf; the ranges' (m, l, acc) merged in
    range order. int8 takes the exact products with the codes (f32 here;
    the kernel's three-part TF32 splits of q and P·vscale are exact to
    2^-33), times the key scale after S and the value scale before P·V."""
    B, H, T, d = q.shape
    ps, NP = kp.shape[2], bt.shape[1]
    Tmax = NP * ps
    BN = 32 if d == 128 else 64
    quant = kscales is not None
    qs = q * torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    out = torch.empty_like(q)
    for b in range(B):
        p0 = int(pos[b])
        for q0 in range(0, T, 64):
            kend = min(Tmax, p0 + min(q0 + 64, T))
            ntiles = -(-kend // BN)
            per = -(-ntiles // splits)
            for w0 in range(q0, min(q0 + 64, T), 16):
                rows = torch.arange(w0, min(w0 + 16, T))
                qr = qs[b][:, rows]                              # [H, R, d]
                parts = []
                for sp in range(splits):
                    m = torch.full((H, len(rows), 1), -1e30)
                    l = torch.zeros(H, len(rows), 1)
                    acc = torch.zeros(H, len(rows), d)
                    for it in range(min(ntiles, sp * per),
                                    min(ntiles, sp * per + per)):
                        k0 = it * BN
                        if k0 > p0 + w0 + 15:        # causally past the warp
                            continue
                        cols = torch.arange(k0, k0 + BN)
                        walked = cols < kend
                        cw = cols.clamp(max=kend - 1)
                        pages, offs = bt[b, cw // ps].long(), cw % ps
                        keep = walked[None, :, None]
                        kk = torch.where(keep, kp[pages, :, offs].float()
                                         .transpose(0, 1), 0.0)  # [H, BN, d]
                        vv = torch.where(keep, vp[pages, :, offs].float()
                                         .transpose(0, 1), 0.0)
                        if quant:
                            ksc = torch.where(walked, kscales[pages, :, offs]
                                              .T, 0.0)[:, None, :]
                            vsc = torch.where(walked, vscales[pages, :, offs]
                                              .T, 0.0)[:, None, :]
                            s = (qr @ kk.transpose(-1, -2)) * ksc
                        else:
                            s = _mm_tf32x3(qr, kk.transpose(-1, -2))
                        if key_valid is not None:
                            ok = key_valid[b, cw] != 0
                            s = torch.where(ok, s, torch.full_like(s, -1e30))
                        s = torch.where(cols[None, :] > p0 + rows[:, None],
                                        torch.full_like(s, -1e30), s)
                        s = torch.where(walked, s,
                                        torch.full_like(s, -math.inf))
                        mx = torch.maximum(m, s.amax(-1, keepdim=True))
                        alpha, p = torch.exp2(m - mx), torch.exp2(s - mx)
                        l = l * alpha + p.sum(-1, keepdim=True)
                        pv = (p * vsc) @ vv if quant else _mm_tf32x3(p, vv)
                        acc = acc * alpha + pv
                        m = mx
                    parts.append((m, l, acc))
                mx = torch.stack([pm for pm, _, _ in parts]).amax(0)
                lsum = torch.zeros(H, len(rows), 1)
                o = torch.zeros(H, len(rows), d)
                for pm, pl_, pa in parts:                # fixed range order
                    e = torch.exp2(pm - mx)
                    lsum = lsum + pl_ * e
                    o = o + pa * e
                out[b][:, rows] = o / lsum.clamp_min(1e-30)
    return out


def _long_case(quant):
    """Two q tiles, the second ragged (T=100), d=32, page size 16 over a
    256-column cache: row 0 from position 0, row 1 from a page boundary
    with right padding, row 2 all masked on garbage page 0."""
    rs = np.random.RandomState(40 + int(quant))
    B, H2, T, d, ps, NP2 = 3, 2, 100, 32, 16, 16
    pages = B * NP2 + 1
    pool = _pool(rs, pages, quant, h=H2, ps=ps, d=d)
    bt = (rs.permutation(pages - 1)[:B * NP2] + 1).reshape(B, NP2).astype(
        np.int32)
    pos = np.array([0, 2 * ps, 0], np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, 90:] = 0
    mask[2, :] = 0
    bt[2, :] = 0
    q = rs.randn(B, H2, T, d).astype(np.float32)
    return q, pool, bt, pos, mask


def _chunk_check(q, pool, bt, pos, mask, splits):
    """The chunk walk against the plain version and both JAX backends on
    every row that sees a column (atol 1e-5); rows that see none finite."""
    B, _, T, _ = q.shape
    Tmax = bt.shape[1] * pool["kpages"].shape[2]
    t = {k: torch.from_numpy(v) for k, v in pool.items()}
    tq, tbt, tpos = (torch.from_numpy(a) for a in (q, bt, pos))
    key_valid = None
    if mask is not None:
        key_valid = ppa._key_valid_plane(torch.from_numpy(mask), tpos, T,
                                         Tmax)
    kw = dict(kscales=t.get("kscales"), vscales=t.get("vscales"))
    got = _k2_chunk_walk(tq, t["kpages"], t["vpages"], tbt, tpos,
                         key_valid=key_valid, splits=splits, **kw)
    plain = ppa.paged_attention_plain(tq, t["kpages"], t["vpages"], tbt,
                                      tpos, key_valid=key_valid, **kw)

    def jx(helper):
        return np.asarray(helper.attend(
            jnp.asarray(q), jnp.asarray(pool["kpages"]),
            jnp.asarray(pool["vpages"]), jnp.asarray(bt), jnp.asarray(pos),
            mask=None if mask is None else jnp.asarray(mask),
            kscales=None if "kscales" not in pool else jnp.asarray(
                pool["kscales"]),
            vscales=None if "vscales" not in pool else jnp.asarray(
                pool["vscales"])))

    assert torch.isfinite(got).all()
    col = torch.arange(Tmax)
    vis = col[None, None] <= tpos.long()[:, None, None] + torch.arange(T)[
        None, :, None]
    if key_valid is not None:
        vis = vis & (key_valid[:, None] != 0)
    seen = vis.any(-1)[:, None, :, None].expand_as(got).numpy()
    for ref in (plain.numpy(), jx(jppa.XlaPagedAttention()),
                jx(jppa.PallasPagedAttention(interpret=True))):
        np.testing.assert_allclose(np.where(seen, got.numpy(), 0),
                                   np.where(seen, ref, 0), atol=1e-5, rtol=0)
    return got, seen


@pytest.mark.parametrize("splits", [1, 3], ids=["unsplit", "split3"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_k2_chunk_walk_design_matches_plain_and_jax(name, quant, splits):
    """The file's geometries (one 64-key tile spanning all four pages of a
    32-column cache, so three splits leave empty ranges) through the chunk
    design, unsplit and split."""
    _chunk_check(*_case(name, quant), splits=splits)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_k2_chunk_walk_two_ragged_q_tiles(quant):
    """T=100 at d=32: two q tiles, the second ragged, walks of up to three
    64-key tiles crossing pages, a row on garbage page 0, split three ways
    (the kernel's rule splits a grid this small)."""
    _chunk_check(*_long_case(quant), splits=3)


def test_k2_chunk_split_and_unsplit_walks_are_order_fixed():
    """Unsplit and split walks each run twice are bitwise equal (fixed
    merge order, no atomics), and agree with each other on every row that
    sees a column."""
    q, pool, bt, pos, mask = _long_case(False)
    t = {k: torch.from_numpy(v) for k, v in pool.items()}
    tpos = torch.from_numpy(pos)
    key_valid = ppa._key_valid_plane(torch.from_numpy(mask), tpos,
                                     q.shape[2], bt.shape[1] * 16)
    args = (torch.from_numpy(q), t["kpages"], t["vpages"],
            torch.from_numpy(bt), tpos)
    one = [_k2_chunk_walk(*args, key_valid=key_valid) for _ in range(2)]
    split = [_k2_chunk_walk(*args, key_valid=key_valid, splits=3)
             for _ in range(2)]
    assert torch.equal(one[0], one[1]) and torch.equal(split[0], split[1])
    seen = np.ones(q.shape, bool)
    seen[2] = False                              # the all-masked row
    np.testing.assert_allclose(np.where(seen, split[0].numpy(), 0),
                               np.where(seen, one[0].numpy(), 0), atol=1e-6,
                               rtol=0)


def _bf16_case(name, quant):
    """``_case``'s geometry with a bf16 query and bf16 pools (int8 pools
    keep their f32 scales)."""
    q, pool, bt, pos, mask = _case(name, quant)
    if not quant:
        pool = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in
                pool.items()}
    return jnp.asarray(q).astype(jnp.bfloat16), pool, bt, pos, mask


def _t(a):
    """A JAX or numpy array as a torch tensor of the same dtype (bf16 by
    way of f32, exactly)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_at_bf16(name, quant):
    """A bf16 query (bf16 pools, or int8 pools under it): the port's plain
    version, computed in bf16 as JAX's ``XlaPagedAttention`` computes it,
    within 2^-6·max|o| of it (each side rounds the scores, weights and
    products to bf16 at its own places: a few bf16 ulps); and on the
    f32-widened inputs, rounded once to bf16, within one bf16 ulp of
    max|o| of the Pallas kernel (interpret mode), whose arithmetic that
    is and K2's 16-bit path follows."""
    q, pool, bt, pos, mask = _bf16_case(name, quant)
    ks, vs = pool.get("kscales"), pool.get("vscales")
    kw = dict(mask=None if mask is None else jnp.asarray(mask),
              kscales=None if ks is None else jnp.asarray(ks),
              vscales=None if vs is None else jnp.asarray(vs))
    args = (q, jnp.asarray(pool["kpages"]), jnp.asarray(pool["vpages"]),
            jnp.asarray(bt), jnp.asarray(pos))
    ref_xla = np.asarray(jppa.XlaPagedAttention().attend(*args, **kw)
                         .astype(jnp.float32))
    ref_pallas = np.asarray(jppa.PallasPagedAttention(interpret=True)
                            .attend(*args, **kw).astype(jnp.float32))
    targs = [_t(a) for a in args]
    tkw = dict(mask=None if mask is None else torch.from_numpy(mask),
               kscales=None if ks is None else _t(ks),
               vscales=None if vs is None else _t(vs))
    got = ppa.paged_attend("xla", *targs, **tkw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    wide = [targs[0].float(), targs[1] if quant else targs[1].float(),
            targs[2] if quant else targs[2].float(), targs[3], targs[4]]
    widened = ppa.paged_attend("xla", *wide, **tkw).to(
        torch.bfloat16).float().numpy()
    # rows that see no column (the all-masked one) differ by design
    seen = np.isfinite(ref_xla).all(-1) & (np.abs(ref_xla).sum(-1) > 0)
    if mask is not None:
        seen &= (mask != 0)[:, None, :]
    top = np.abs(ref_pallas[seen]).max()
    np.testing.assert_allclose(got[seen], ref_xla[seen], atol=2 ** -6 * top,
                               rtol=0)
    np.testing.assert_allclose(widened[seen], ref_pallas[seen],
                               atol=2 ** -7 * top, rtol=0)
