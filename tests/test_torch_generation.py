"""Port parity: the port's ``GenerationServer`` (paged KV, wave prefill in
chunks, fused decode dispatches) against the JAX ``GenerationServer`` with
``paged_attention="xla"`` on the same weights.

Six greedy prompts of mixed length: one longer than ``prefill_chunk`` (so it
prefills over two rounds), one that finishes on its ``eos_id``, and one whose
last decode dispatch reaches the per-slot capacity clamp. The token lists
must be identical, for f32 and for int8 KV pages.

The weights are drawn with numpy at a gain that makes the greedy streams
vary; the same arrays go to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models.zoo import (  # noqa: E402
    TransformerLM as JaxTransformerLM)
from deeplearning4j_tpu.parallel.generation import (  # noqa: E402
    GenerationServer as JaxGenerationServer)
from deeplearning4j_torch.models.zoo import TransformerLM  # noqa: E402
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer, _PagePool)
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    ServerOverloaded)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

V = 17
CAP = 32                          # max_cache: 4 pages of 8
SERVER = dict(slots=3, page_size=8, prefill_chunk=16, steps_per_dispatch=4)
# (prompt length, max_tokens): 20 > prefill_chunk; 21 + 12 - 1 == CAP, so
# the last dispatch's final micro-step hits the capacity clamp
SHAPES = [(3, 6), (20, 8), (9, 5), (21, 12), (1, 10), (12, 7)]
CLAMP_REQ = 3


def _np_params(net, seed, gain=2.0):
    rs = np.random.RandomState(seed)
    out = {}
    for v, p in net.params.items():
        out[v] = {}
        for k, t in p.items():
            shp = tuple(t.shape)
            if k.startswith("W"):
                a = rs.randn(*shp) * gain / np.sqrt(shp[0])
            elif k == "gamma":
                a = 1.0 + 0.1 * rs.randn(*shp)
            else:
                a = 0.1 * rs.randn(*shp)
            out[v][k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def nets():
    kw = dict(num_labels=V, max_length=16, d_model=32, n_heads=4, n_blocks=2)
    tnet = TransformerLM(max_cache=CAP, **kw).init(device="cpu")
    params = _np_params(tnet, 7)
    params_from_jax(params, tnet)
    jnet = JaxTransformerLM(seed=3, **kw).init()
    for _, layer in jnet._stream_layers():
        if hasattr(layer, "max_cache"):
            layer.max_cache = CAP
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jnet, tnet


def _serve(server, reqs):
    try:
        futs = [server.submit(p, n, eos_id=e) for p, n, e in reqs]
        return [list(np.asarray(f.result(timeout=120))) for f in futs]
    finally:
        server.close()


@pytest.fixture(scope="module")
def requests(nets):
    """The six requests plus (r, i): request r gets as its eos_id the token
    the reference first emits at position i without one, so it must stop
    after i + 1 tokens. The clamp request keeps running to capacity."""
    jnet, _ = nets
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, V, n) for n, _ in SHAPES]
    plain = _serve(JaxGenerationServer(jnet, V, paged_attention="xla",
                                       **SERVER),
                   [(p, n, None) for p, (_, n) in zip(prompts, SHAPES)])
    r, i = next((r, i) for r, stream in enumerate(plain) if r != CLAMP_REQ
                for i in range(1, len(stream) - 1)
                if stream[i] not in stream[:i])
    eos = int(plain[r][i])
    reqs = [(p, n, eos if k == r else None)
            for k, (p, (_, n)) in enumerate(zip(prompts, SHAPES))]
    return reqs, (r, i)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_greedy_tokens_identical_to_jax(nets, requests, kv_dtype):
    jnet, tnet = nets
    requests, (r, i) = requests
    ref = _serve(JaxGenerationServer(jnet, V, paged_attention="xla",
                                     kv_dtype=kv_dtype, **SERVER), requests)
    got = _serve(GenerationServer(tnet, V, kv_dtype=kv_dtype, device="cpu",
                                  **SERVER), requests)
    assert got == ref
    # the schedule covered what it claims to cover
    assert len(got[r]) == i + 1 and got[r][-1] == requests[r][2]
    assert [len(t) for k, t in enumerate(got) if k != r] == \
        [n for k, (_, n) in enumerate(SHAPES) if k != r]
    assert len(set(sum(got, []))) > 2, "degenerate greedy streams"


def test_pages_return_to_the_pool(nets, requests):
    _, tnet = nets
    requests, _ = requests
    srv = GenerationServer(tnet, V, device="cpu", **SERVER)
    try:
        futs = [srv.submit(p, n, eos_id=e) for p, n, e in requests]
        for f in futs:
            f.result(timeout=120)
        assert srv.drain(timeout=30)
        st = srv.stats()
        assert st["completed"] == len(requests) and st["active_slots"] == 0
        # every page is free or held by the prefix cache (reclaimable);
        # no slot holds one
        pages = st["pages"]
        assert pages["pages_free"] + pages["pages_cached"] == \
            pages["pages_total"] - 1
        assert pages["pages_refcounted"] == 0
        assert srv._prefill_rounds >= 2       # the long prompt took two
        assert st["pending"] == 0
    finally:
        srv.close()


def test_unfittable_request_raises_overloaded(nets):
    _, tnet = nets
    srv = GenerationServer(tnet, V, device="cpu", **SERVER)
    try:
        with pytest.raises(ServerOverloaded, match="KV capacity"):
            srv.submit(np.arange(30) % V, 4)          # 30 + 4 - 1 > 32
        small = GenerationServer(tnet, V, device="cpu", pages=3, **SERVER)
        try:
            with pytest.raises(ServerOverloaded, match="usable pages"):
                small.submit(np.arange(10) % V, 10)   # 3 pages > 2 usable
        finally:
            small.close()
        assert srv.submit(np.arange(21) % V, 12).result(timeout=60).size == 12
    finally:
        srv.close()


def test_sampled_decoding_serves(nets):
    """Sampled decoding is ported now (``tests/test_torch_sampling.py``
    holds its streams against JAX's): a sampled request serves to its
    ``max_tokens``, and the same seed gives the same stream."""
    _, tnet = nets
    srv = GenerationServer(tnet, V, device="cpu", **SERVER)
    try:
        a, b = [srv.submit(np.arange(4), 3, temperature=0.7, seed=9)
                for _ in range(2)]
        assert a.result(timeout=60).tolist() == b.result(timeout=60).tolist()
        assert a.result().size == 3
    finally:
        srv.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_bf16_model_serves(kv_dtype):
    """A bf16 TransformerLM serves (ROADMAP C1): bf16 pages, or int8 pages
    under bf16 activations, greedy and sampled, every request to its
    length."""
    kw = dict(num_labels=V, max_length=16, d_model=32, n_heads=4, n_blocks=2)
    net = TransformerLM(max_cache=CAP, dtype="bfloat16", **kw).init(
        device="cpu")
    params_from_jax(_np_params(net, 7), net)
    assert net.params["attn0"]["Wq"].dtype == torch.bfloat16
    rs = np.random.RandomState(1)
    srv = GenerationServer(net, V, device="cpu", kv_dtype=kv_dtype, **SERVER)
    try:
        futs = [srv.submit(rs.randint(0, V, n), m, temperature=t, seed=n)
                for n, m, t in ((3, 6, 0.0), (20, 8, 0.9), (9, 5, 0.0))]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        srv.close()
    assert [o.size for o in outs] == [6, 8, 5]
    assert all(((o >= 0) & (o < V)).all() for o in outs)


@pytest.mark.parametrize("prompt", [[3, V], [-1, 2], [0.5, 1.0], []])
def test_bad_prompts_are_rejected_at_submit(nets, prompt):
    """Out-of-vocabulary, negative, non-integer or empty prompts fail the
    caller at submit; they never reach (and fail) the shared decode batch."""
    _, tnet = nets
    srv = GenerationServer(tnet, V, device="cpu", **SERVER)
    try:
        with pytest.raises(ValueError, match="prompt_ids"):
            srv.submit(np.asarray(prompt), 3)
        assert srv.submit(np.arange(5), 3).result(timeout=60).size == 3
    finally:
        srv.close()


def test_closed_server_rejects_and_restores_knob(nets):
    _, tnet = nets
    layers = [lyr for _, lyr in tnet._stream_layers()
              if hasattr(lyr, "paged_attention")]
    srv = GenerationServer(tnet, V, device="cpu", paged_attention="stock",
                           **SERVER)
    assert all(lyr.paged_attention == "stock" for lyr in layers)
    srv.close()
    srv.close()                                        # idempotent
    assert all(lyr.paged_attention == "auto" for lyr in layers)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.arange(4), 3)


def test_page_pool_accounting():
    pool = _PagePool(4)
    assert pool.in_use() == 0
    a, b, c = pool.alloc(), pool.alloc(), pool.alloc()
    assert (a, b, c) == (1, 2, 3) and pool.alloc() is None
    pool.release(b)
    assert pool.in_use() == 2 and pool.alloc() == b and pool.peak == 3
