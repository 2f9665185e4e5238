"""Port parity: speculative decoding in the port's ``GenerationServer``
against the JAX ``GenerationServer`` (``paged_attention="xla"``) and the
serial references, on the CPU.

Both nets of every comparison hold the JAX package's weights (the target a
JAX ``TransformerLM`` at seed 3, the mismatched draft one at seed 99, both
loaded into the port through ``params_from_jax``). Emitted tokens are the
target's selections under the serial key schedule, so every stream must
equal JAX's and the serial reference token for token (exact equality:
both compute in f32 here), and with requests served one at a time the
speculative counters (``spec_rounds``, ``spec_proposed``,
``spec_accepted``) must equal JAX's too. The per-row dense streaming
forward the draft runs, and ``spec_verify_tokens``, are held to JAX's
functions directly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers.attention import (  # noqa: E402
    SelfAttentionLayer as JaxSelfAttention)
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_torch.models import zoo  # noqa: E402
from deeplearning4j_torch.nn.conf.layers.attention import (  # noqa: E402
    SelfAttentionLayer)
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer)
from deeplearning4j_torch.parallel.handoff import (  # noqa: E402
    SnapshotUnsupported)
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    ServerOverloaded)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 17
CAP = 64                          # max_cache of every net here
SERVER = dict(slots=3, page_size=8)
SHAPES = [(3, 6), (5, 4), (9, 5), (3, 5), (5, 6), (9, 4)]
SAMPLED = dict(temperature=0.9, top_k=5, seed=7)


def jax_pair(seed, d_model, n_blocks=1, cap=CAP):
    """A JAX ``TransformerLM`` (its own initialisation at ``seed``) and the
    port's twin holding the same weights."""
    jnet = jzoo.TransformerLM(num_labels=V, max_length=16, d_model=d_model,
                              n_heads=2, n_blocks=n_blocks, seed=seed).init()
    for _, layer in jnet._stream_layers():
        if hasattr(layer, "max_cache"):
            layer.max_cache = cap
    tnet = zoo.TransformerLM(num_labels=V, max_length=16, d_model=d_model,
                             n_heads=2, n_blocks=n_blocks,
                             max_cache=cap).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def make_server(which, net_pair, **kw):
    jnet, tnet = net_pair
    if which == "jax":
        kw = {k: v[0] if k == "draft_net" else v for k, v in kw.items()}
        return JaxGenerationServer(jnet, V, paged_attention="xla", **kw)
    kw = {k: v[1] if k == "draft_net" else v for k, v in kw.items()}
    return GenerationServer(tnet, V, device="cpu", **kw)


@pytest.fixture(scope="module")
def lm():
    return jax_pair(3, 16)


@pytest.fixture(scope="module")
def draft():
    return jax_pair(99, 8)


@pytest.fixture(scope="module")
def refs(lm):
    """The request set, a sampled request, and their serial references
    (JAX's ``greedy_generate`` / ``sample_generate``)."""
    jnet, _ = lm
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, V, p), s) for p, s in SHAPES]
    greedy = [jzoo.greedy_generate(jnet, p[None], s, V)[0].tolist()
              for p, s in reqs]
    sp = rs.randint(0, V, 4)
    sampled = jzoo.sample_generate(jnet, sp[None], 6, V,
                                   **SAMPLED)[0].tolist()
    return reqs, greedy, (sp, 6), sampled


def _serve(srv, reqs, sampled=None, *, sequential=False):
    """Serve ``reqs`` (greedy) and the optional sampled request; returns
    (token lists, stats). ``sequential`` waits for each result before the
    next submit, so the round schedule does not depend on timing."""
    try:
        jobs = [lambda p=p, s=s: srv.submit(p, s) for p, s in reqs]
        if sampled is not None:
            jobs.append(lambda: srv.submit(*sampled, **SAMPLED))
        if sequential:
            outs = [job().result(timeout=180).tolist() for job in jobs]
        else:
            futs = [job() for job in jobs]
            outs = [f.result(timeout=180).tolist() for f in futs]
        assert srv.drain(timeout=30)
    finally:
        srv.close()
    # after close: the loop thread is joined, every counter published
    return outs, srv.stats()


SPEC_KEYS = ("spec_k", "spec_rounds", "spec_proposed", "spec_accepted")


def test_spec_verify_tokens_bitwise_jax():
    """K selections per row under ``fold_in(key, count + i)``: greedy,
    sampled and top-k rows, keys of seeds past 2^32 (two-word keys)."""
    rs = np.random.RandomState(1)
    B, K = 4, 5
    logits = rs.randn(B, K, V).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(np.float32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s))
                     for s in (0, 7, 2 ** 40 + 3, 12345)])
    counts = np.array([0, 3, 11, 6], np.int32)
    temp = np.array([0.0, 0.8, 1.3, 0.5], np.float32)
    topk = np.array([0, 5, 0, 1], np.int32)
    want = jzoo.spec_verify_tokens(jnp.asarray(probs), jnp.asarray(keys),
                                   jnp.asarray(counts), jnp.asarray(temp),
                                   jnp.asarray(topk))
    got = zoo.spec_verify_tokens(
        torch.from_numpy(probs), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(counts), torch.from_numpy(temp),
        torch.from_numpy(topk.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_per_row_streaming_matches_jax(quant, masked):
    """One dense streaming chunk with a ``[B]`` ``cache_pos`` through both
    layers: outputs within atol 1e-6, caches (and int8 scale strips)
    written at each row's own position equal to JAX's; a chunk past a
    row's capacity raises."""
    rs = np.random.RandomState(20 + 2 * quant + masked)
    B, T, F, Tmax = 3, 4, 16, 24
    kw = dict(n_in=F, n_out=F, n_heads=2, causal=True, max_cache=Tmax,
              bias_init=0.0)
    jl = JaxSelfAttention(**kw)
    tl = SelfAttentionLayer(**kw)
    tl.finalize()
    params = {k: np.array(v) for k, v in
              jl.init_params(jax.random.PRNGKey(0)).items()}
    # identity K/V projections: both sides write (and quantize) the same
    # f32 values
    params["Wk"] = np.eye(F, dtype=np.float32)
    params["Wv"] = np.eye(F, dtype=np.float32)
    params["b"] = (0.1 * rs.randn(F)).astype(np.float32)
    shape = (B, 2, Tmax, F // 2)
    if quant:
        cache = dict(kcache=rs.randint(-127, 128, shape).astype(np.int8),
                     vcache=rs.randint(-127, 128, shape).astype(np.int8),
                     kscale=rs.rand(*shape[:3]).astype(np.float32) / 100,
                     vscale=rs.rand(*shape[:3]).astype(np.float32) / 100)
    else:
        cache = dict(kcache=rs.randn(*shape).astype(np.float32),
                     vcache=rs.randn(*shape).astype(np.float32))
    pos = np.array([0, 9, Tmax - T], np.int32)
    x = rs.randn(B, T, F).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 2:] = 0
        mask[2, 1:] = 0
    jstate = {k: jnp.asarray(v) for k, v in cache.items()}
    jstate["cache_pos"] = jnp.asarray(pos)
    jout, jst = jl._streaming_forward(
        {k: jnp.asarray(v) for k, v in params.items()}, jstate,
        jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    tstate = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tstate["cache_pos"] = torch.from_numpy(pos)
    tout, tst = tl._streaming_forward(
        {k: torch.from_numpy(v) for k, v in params.items()}, tstate,
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=0)
    for key in cache:
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
        assert tst[key] is tstate[key]            # written in place
    np.testing.assert_array_equal(tst["cache_pos"].numpy(), pos + T)
    with pytest.raises(ValueError, match="KV cache overflow"):
        tl._streaming_forward(
            {k: torch.from_numpy(v) for k, v in params.items()},
            dict(tstate, cache_pos=torch.tensor([0, Tmax - T + 1, 0],
                                                dtype=torch.int32)),
            torch.from_numpy(x))


@pytest.mark.parametrize("spec_k", [4, 5])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("which", ["perfect", "mismatched"])
def test_speculative_tokens_equal_jax_and_serial(lm, draft, refs, which,
                                                 kv_dtype, spec_k):
    """Greedy and sampled streams of the port's speculative server equal
    JAX's speculative server's and (f32 KV) the serial references; served
    one at a time, the speculative counters equal JAX's."""
    reqs, greedy, sampled, sref = refs
    d = lm if which == "perfect" else draft
    kw = dict(SERVER, draft_net=d, spec_k=spec_k, kv_dtype=kv_dtype)
    want, jst = _serve(make_server("jax", lm, **kw), reqs, sampled,
                       sequential=True)
    got, st = _serve(make_server("port", lm, **kw), reqs, sampled,
                     sequential=True)
    assert got == want
    if kv_dtype is None:
        assert got == greedy + [sref]
    assert {k: st["pages"][k] for k in SPEC_KEYS} == \
        {k: jst["pages"][k] for k in SPEC_KEYS}
    assert st["pages"]["spec_rounds"] > 0
    rate = st["pages"]["spec_accept_rate"]
    assert rate > 0.9 if which == "perfect" else rate < 1.0
    assert st["pages"]["pages_refcounted"] == 0


def test_speculative_concurrent_batch_equals_serial(lm, draft, refs):
    """A concurrent batch (rows at different depths in one round) still
    emits the serial references' tokens."""
    reqs, greedy, sampled, sref = refs
    got, st = _serve(make_server("port", lm, **SERVER, draft_net=draft,
                                 spec_k=4), reqs, sampled)
    assert got == greedy + [sref]
    assert st["completed"] == len(reqs) + 1 and st["failed"] == 0


def test_eos_mid_speculative_round(lm, refs):
    """EOS inside a verified chunk ends the emission at (and including) the
    EOS token, as the serial path does."""
    reqs, greedy, _, _ = refs
    (p0, s0), ref0 = reqs[0], greedy[0]
    eos = ref0[3]
    k = ref0.index(eos)
    for which in ("jax", "port"):
        srv = make_server(which, lm, **SERVER, draft_net=lm, spec_k=4)
        try:
            got = srv.submit(p0, s0, eos_id=eos).result(timeout=180)
        finally:
            srv.close()
        assert got.tolist() == ref0[:k + 1], which


@pytest.mark.parametrize("kw, exc, jexc", [
    (dict(spec_k=1), ValueError, ValueError),
    (dict(snapshot_every=4), ValueError, ValueError),
    (dict(role="prefill"), ValueError, ValueError),
    (dict(small_draft=True), ValueError, ValueError),
], ids=["spec_k", "snapshot_every", "prefill_role", "draft_capacity"])
def test_constructor_refusals_match_jax(lm, kw, exc, jexc):
    """The speculative constructor contract raises JAX's exception types:
    ``spec_k < 2``, periodic snapshots or the prefill role with a draft,
    and a draft that cannot reach the target's capacity."""
    kw = dict(kw)
    d = jax_pair(5, 8, cap=CAP // 2) if kw.pop("small_draft", False) else lm
    with pytest.raises(jexc):
        make_server("jax", lm, draft_net=d, **SERVER, **kw)
    with pytest.raises(exc):
        make_server("port", lm, draft_net=d, **SERVER, **kw)


def test_speculative_export_and_margin_refused(lm):
    """A speculative server refuses to export or adopt (its draft cache is
    not part of the wire format) and admits with the ``spec_k - 1``
    look-ahead margin, as JAX's does."""
    srv = make_server("port", lm, **SERVER, draft_net=lm, spec_k=4)
    try:
        with pytest.raises(SnapshotUnsupported):
            srv.submit(np.arange(4), 4, export_kv=True)
        fut = srv.submit(np.arange(4), 4)
        with pytest.raises(SnapshotUnsupported):
            srv.export_request(fut)
        fut.result(timeout=60)
        # 60 + 3 - 1 + 3 (margin) > 64; without the margin it would fit
        with pytest.raises(ServerOverloaded, match="look-ahead"):
            srv.submit(np.arange(60) % V, 3)
    finally:
        srv.close()
