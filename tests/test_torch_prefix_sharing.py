"""Port parity: prefix sharing with copy-on-write, preemption and deadlines
in the port's ``GenerationServer`` against the JAX ``GenerationServer``
(``paged_attention="xla"``) on the same numpy-drawn weights, on the CPU.

Requests share a two-page system prompt and differ in their suffixes. The
token lists must be identical to JAX's (both compute in f32 here: exact
token equality), and with sequential submission the prefix-cache counters
(``prefix_hits``, ``prefix_tokens_reused``, ``cow_copies``) must equal the
JAX server's, since both run the same page bookkeeping.
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
    GenerationServer)
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    DeadlineExceeded)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 17
CAP = 64                          # max_cache: 8 pages of 8
SERVER = dict(slots=3, page_size=8, prefill_chunk=16, steps_per_dispatch=4)
SYSTEM = np.random.RandomState(11).randint(0, V, 16)   # two full pages
# suffix lengths: a partial page, exactly one page, a single token, and a
# suffix that spans a page boundary
SUFFIXES = [5, 8, 1, 11, 3, 7]
NEW_TOKENS = 10


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


def _prompts():
    rs = np.random.RandomState(5)
    return [np.concatenate([SYSTEM, rs.randint(0, V, n)]) for n in SUFFIXES]


def _make(which, nets, **kw):
    jnet, tnet = nets
    if which == "jax":
        return JaxGenerationServer(jnet, V, paged_attention="xla", **kw)
    return GenerationServer(tnet, V, device="cpu", **kw)


def _serve(srv, prompts, *, sequential=False, sampled_every=0):
    """Serve ``prompts`` (NEW_TOKENS each; every ``sampled_every``-th one
    sampled): the first alone so its prefix is registered, then the rest
    together (or one at a time). Returns (token lists, stats)."""
    def sub(i, p):
        if sampled_every and i % sampled_every == 1:
            return srv.submit(p, NEW_TOKENS, temperature=0.8, top_k=6,
                              seed=100 + i)
        return srv.submit(p, NEW_TOKENS)

    try:
        outs = [sub(0, prompts[0]).result(timeout=120).tolist()]
        if sequential:
            outs += [sub(i, p).result(timeout=120).tolist()
                     for i, p in enumerate(prompts[1:], 1)]
        else:
            futs = [sub(i, p) for i, p in enumerate(prompts[1:], 1)]
            outs += [f.result(timeout=120).tolist() for f in futs]
        assert srv.drain(timeout=30)
        return outs, srv.stats()
    finally:
        srv.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_shared_prefix_tokens_equal_jax(nets, kv_dtype):
    prompts = _prompts()
    ref, jst = _serve(_make("jax", nets, kv_dtype=kv_dtype, **SERVER),
                      prompts, sampled_every=2)
    got, st = _serve(_make("port", nets, kv_dtype=kv_dtype, **SERVER),
                     prompts, sampled_every=2)
    assert got == ref
    assert st["pages"]["prefix_hits"] >= len(prompts) - 1
    assert st["pages"]["cow_copies"] >= 1
    # the same server without sharing gives the same tokens
    off, ost = _serve(_make("port", nets, kv_dtype=kv_dtype,
                            prefix_cache=False, **SERVER), prompts,
                      sampled_every=2)
    assert off == got
    assert ost["pages"]["prefix_hits"] == ost["pages"]["cow_copies"] == 0
    assert len(set(sum(got, []))) > 2, "degenerate streams"


def test_sequential_prefix_counters_equal_jax(nets):
    prompts = _prompts()
    ref, jst = _serve(_make("jax", nets, **SERVER), prompts, sequential=True)
    got, st = _serve(_make("port", nets, **SERVER), prompts, sequential=True)
    assert got == ref
    keys = ("prefix_hits", "prefix_tokens_reused", "cow_copies",
            "pages_cached", "evictions", "preempted")
    assert {k: st["pages"][k] for k in keys} == \
        {k: jst["pages"][k] for k in keys}
    assert st["pages"]["prefix_hits"] == len(prompts) - 1
    assert st["pages"]["prefix_tokens_reused"] == \
        len(SYSTEM) * st["pages"]["prefix_hits"]
    # drained: nothing refcounted, every page free or held by the cache
    assert st["pages"]["pages_refcounted"] == 0
    assert st["pages"]["pages_free"] + st["pages"]["pages_cached"] == \
        st["pages"]["pages_total"] - 1


def test_whole_prompt_resident_copies_its_last_page(nets):
    """A prompt already resident in full shares every page and prefills
    its last token again into a copy of the shared tail page."""
    p = _prompts()[0]
    outs = {}
    for which in ("jax", "port"):
        srv = _make(which, nets, **SERVER)
        try:
            a = srv.submit(p, NEW_TOKENS).result(timeout=120).tolist()
            b = srv.submit(p, NEW_TOKENS).result(timeout=120).tolist()
            outs[which] = (a, b, srv.stats()["pages"]["prefix_tokens_reused"])
        finally:
            srv.close()
    assert outs["port"] == outs["jax"]
    a, b, reused = outs["port"]
    assert a == b and reused == len(p) - 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_preemption_keeps_tokens_and_returns_pages(nets, kv_dtype):
    """A pool of 9 usable pages cannot hold three slots of up to 5 pages:
    the newest slot is preempted (snapshot-resumed once it has decoded a
    page, else recomputed) and every stream still equals the roomy
    server's and JAX's under the same pool."""
    prompts = _prompts()
    roomy, _ = _serve(_make("port", nets, kv_dtype=kv_dtype, **SERVER),
                      prompts, sampled_every=2)
    ref, _ = _serve(_make("jax", nets, kv_dtype=kv_dtype, pages=10,
                          **SERVER), prompts, sampled_every=2)
    got, st = _serve(_make("port", nets, kv_dtype=kv_dtype, pages=10,
                           **SERVER), prompts, sampled_every=2)
    assert got == roomy == ref
    assert st["pages"]["preempted"] >= 1
    assert st["pages"]["pages_refcounted"] == 0
    assert st["pages"]["pages_free"] + st["pages"]["pages_cached"] == 9
    assert st["completed"] == len(prompts) and st["failed"] == 0


def test_preemption_survives_a_failed_snapshot(nets, monkeypatch):
    """Preemption is best effort: a victim whose snapshot fails (here every
    snapshot raises) recomputes from token 0, and no request fails."""
    prompts = _prompts()
    roomy, _ = _serve(_make("port", nets, **SERVER), prompts, sampled_every=2)
    calls = []

    def broken(self, slot):
        calls.append(slot)
        raise RuntimeError("device gather failed")

    monkeypatch.setattr(GenerationServer, "_snapshot_slot", broken)
    got, st = _serve(_make("port", nets, pages=10, **SERVER), prompts,
                     sampled_every=2)
    assert calls and got == roomy
    assert st["pages"]["preempted"] >= 1
    assert st["handoff"]["preempt_resumes"] == 0
    assert st["completed"] == len(prompts) and st["failed"] == 0


def test_deadline_fails_typed(nets):
    """An expired budget fails the request typed, queued or resident, and
    frees its pages; requests without one are unaffected."""
    _, tnet = nets
    srv = GenerationServer(tnet, V, device="cpu", **SERVER)
    try:
        with pytest.raises(DeadlineExceeded, match="while queued"):
            srv.submit(np.arange(4), 5, deadline_s=0.0).result(timeout=60)
        # 60 tokens at 4 a dispatch: expires between dispatches
        slow = srv.submit(np.arange(3), CAP - 3, deadline_s=0.02)
        with pytest.raises(DeadlineExceeded):
            slow.result(timeout=60)
        assert srv.submit(np.arange(4), 5).result(timeout=60).size == 5
        assert srv.drain(timeout=30)
        st = srv.stats()
        assert st["expired"] == 2 and st["pages"]["pages_refcounted"] == 0
    finally:
        srv.close()
    srv = GenerationServer(tnet, V, device="cpu", request_deadline_s=0.0,
                           **SERVER)
    try:
        with pytest.raises(DeadlineExceeded):
            srv.submit(np.arange(4), 5).result(timeout=60)
    finally:
        srv.close()


@pytest.mark.parametrize("kw", [dict(tp=2), dict(tp=4),
                                dict(axes=("data",), tp=None),
                                dict(tp=2, claim=4)])
def test_unported_knobs_raise(nets, kw):
    """The tensor-parallel knobs (once refused naming A9) on the shared
    prefix traffic: at tp=2 and tp=4 over ``Mesh([cpu] * tp)`` the
    sequential streams and prefix counters equal JAX's (exact tokens);
    a mesh without a ``model`` axis and a ``tp`` that disagrees with the
    mesh raise ``MeshGeometryError`` with JAX's messages."""
    from deeplearning4j_torch.parallel.mesh import Mesh, MeshGeometryError

    _, tnet = nets
    cpu = torch.device("cpu")
    axes = kw.get("axes", ("model",))
    mesh = Mesh([cpu] * (kw["tp"] or 2), axes)
    if "claim" in kw or axes != ("model",):
        match = "disagrees" if "claim" in kw else "'model' axis"
        with pytest.raises(MeshGeometryError, match=match):
            GenerationServer(tnet, V, mesh=mesh, tp=kw.get("claim"),
                             **SERVER)
        return
    prompts = _prompts()
    ref, jst = _serve(_make("jax", nets, **SERVER), prompts, sequential=True)
    got, st = _serve(GenerationServer(tnet, V, mesh=mesh, **SERVER), prompts,
                     sequential=True)
    assert got == ref
    keys = ("prefix_hits", "prefix_tokens_reused", "cow_copies")
    assert {k: st["pages"][k] for k in keys} == \
        {k: jst["pages"][k] for k in keys}
