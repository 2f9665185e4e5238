"""Port parity: retrieval-augmented serving (the port's ``parallel/rag.py``,
``parallel/generation.py::assemble_passage_prefix`` and the ``/rag`` route)
against the JAX package's, on the CPU — the counterpart of
``tests/test_rag.py``.

- ``assemble_passage_prefix`` returns JAX's prompt, doc order and prefix
  length for the same inputs (retrieval order, duplicates, IVF ``-1`` pads,
  ``pad_id``, no query).
- ``RagPipeline`` validates its arguments as JAX's does, before any replica
  is built; it resolves CUDA by default and refuses a replica built on
  another device.
- One pipeline per package (a tiny ``TransformerLM`` loaded into the port
  with ``params_from_jax``, an exact f32 knn tier), requests served one at
  a time: greedy and sampled streams, ``_rag_docs``, ``_rag_prefix_len``
  and ``_rag_prompt`` equal JAX's, and so do the ledger and the
  prefix-cache counters of ``stats()`` (its keys in JAX's order).
- The slow classes are the counterparts of JAX's ``TestRagPipeline`` and
  ``TestRagRoute`` (marked slow there too): streams equal the port's own
  non-RAG ``greedy_generate``/``sample_generate`` on the assembled prompt,
  hot documents dedupe prefill, one deadline spans both tiers, admission
  sheds typed, tier labels and levers, close, and ``/rag`` over HTTP.

Token streams are compared exactly; there is no float tolerance here.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.nearestneighbors import index as jindex  # noqa
from deeplearning4j_tpu.parallel import generation as jgen  # noqa: E402
from deeplearning4j_tpu.parallel import rag as jrag  # noqa: E402
from deeplearning4j_torch.models import zoo  # noqa: E402
from deeplearning4j_torch.nearestneighbors.index import (  # noqa: E402
    EmbeddingIndex)
from deeplearning4j_torch.parallel.generation import (  # noqa: E402
    GenerationServer, assemble_passage_prefix)
from deeplearning4j_torch.parallel.rag import RagPipeline  # noqa: E402
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    DeadlineExceeded, ServerOverloaded)
from deeplearning4j_torch.utils.convert import params_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port

V = 17
D = 8
NDOCS = 64
PS = 4  # page size on BOTH tiers — the chunk-alignment contract
TIMEOUT = 120


def corpus(seed=0):
    """``tests/test_rag.py::_corpus``: well-separated doc vectors +
    passages of 3..10 tokens."""
    rs = np.random.RandomState(seed)
    vecs = rs.randn(NDOCS, D).astype(np.float32) * 4.0
    passages = [rs.randint(1, V, size=rs.randint(3, 11)).astype(np.int64)
                for _ in range(NDOCS)]
    return vecs, passages


@pytest.fixture(scope="module")
def lms():
    """The JAX ``TransformerLM`` of ``tests/test_rag.py`` and the port's
    twin holding its weights."""
    jnet = jzoo.TransformerLM(num_labels=V, max_length=64, d_model=16,
                              n_heads=2, n_blocks=1, seed=3).init()
    tnet = zoo.TransformerLM(num_labels=V, max_length=64, d_model=16,
                             n_heads=2, n_blocks=1).init(device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params), tnet)
    return jnet, tnet


def port_pipeline(tnet, vecs, passages, slots=4, **kw):
    return RagPipeline(
        lambda rid: EmbeddingIndex(vecs, device="cpu"),
        lambda rid: GenerationServer(tnet, V, slots=slots, page_size=PS,
                                     device="cpu"),
        passages, page_size=PS, k=2, device="cpu", **kw)


def jax_pipeline(jnet, vecs, passages, slots=4):
    return jrag.RagPipeline(
        lambda rid: jindex.EmbeddingIndex(vecs),
        lambda rid: jgen.GenerationServer(jnet, V, slots=slots, page_size=PS,
                                          paged_attention="xla"),
        passages, page_size=PS, k=2)


# ---------------------------------------------------------------------------
# canonical prefix assembly and validation — tier-1
# ---------------------------------------------------------------------------

def test_assemble_passage_prefix_equals_jax():
    _vecs, passages = corpus(1)
    q = np.array([1, 2, 3], np.int64)
    cases = [([7, 3, 11], dict(query_ids=q)),
             ([11, 7, 3], dict(query_ids=q)),
             ([3, 3, 7, 11, 11], dict(query_ids=q)),
             ([7, -1, 3, -1, 11], dict(query_ids=q, pad_id=5)),
             (np.array([[9, 2]]), dict()),
             ([-1, -1], dict(query_ids=q)),
             ([], dict())]
    for ids, kw in cases:
        for ps in (1, PS, 7):
            got = assemble_passage_prefix(ids, passages, page_size=ps, **kw)
            want = jgen.assemble_passage_prefix(ids, passages, page_size=ps,
                                                **kw)
            assert got[0].dtype == want[0].dtype == np.int64
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    base, order, plen = assemble_passage_prefix([7, 3, 11], passages,
                                                page_size=PS, query_ids=q)
    assert order == [3, 7, 11] and plen % PS == 0
    np.testing.assert_array_equal(base[plen:], q)
    for fn in (assemble_passage_prefix, jgen.assemble_passage_prefix):
        with pytest.raises(ValueError, match="page_size"):
            fn([0], passages, page_size=0)


def test_pipeline_ctor_validation_precedes_fleet(monkeypatch):
    def boom(_rid):
        raise AssertionError("factory ran before validation")

    for kw in ({"k": 0}, {"page_size": 0}, {"knn_replicas": 0},
               {"generate_replicas": 0}):
        for cls, extra in ((jrag.RagPipeline, {}),
                           (RagPipeline, {"device": "cpu"})):
            with pytest.raises(ValueError):
                cls(boom, boom, [], **kw, **extra)

    class _Elsewhere:
        device = torch.device("meta")

        def close(self, timeout=0.0):
            pass

    with pytest.raises(ValueError, match="lives on"):
        RagPipeline(lambda rid: _Elsewhere(), boom, [], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RagPipeline(boom, boom, [])


def test_one_pipeline_per_package_streams_equal_jax(lms):
    """Requests one at a time through each package's two-tier pipeline:
    the same docs, prefix lengths, prompts and tokens (greedy and sampled),
    the same ledger and prefix counters; caller errors typed alike."""
    jnet, tnet = lms
    vecs, passages = corpus()
    rs = np.random.RandomState(7)
    reqs = [(rs.randint(1, V, 5), 6, vecs[5] + 0.01, {}),
            (rs.randint(1, V, 4), 5, vecs[9] - 0.01,
             dict(temperature=0.8, top_k=5, seed=11)),
            (rs.randint(1, V, 5), 4, vecs[5] + 0.02, {}),
            (rs.randint(1, V, 3), 4, vecs[40], dict(k=3))]
    got = {}
    for pkg, make in (("jax", lambda: jax_pipeline(jnet, vecs, passages)),
                      ("port", lambda: port_pipeline(tnet, vecs,
                                                     passages))):
        pipe = make()
        outs = []
        try:
            for prompt, n, q, kw in reqs:
                fut = pipe.submit(prompt, n, query_vec=q, **kw)
                toks = np.asarray(fut.result(timeout=TIMEOUT))
                outs.append((toks.tolist(), fut._rag_docs,
                             fut._rag_prefix_len,
                             np.asarray(fut._rag_prompt).tolist()))
            good = np.array([1, 2, 3], np.int64)
            for args, kw, match in (
                    (([], 3), dict(query_vec=vecs[0]), "non-empty"),
                    ((good, 0), dict(query_vec=vecs[0]), "max_tokens"),
                    ((good, 3), dict(query_vec=vecs[0], k=0), "k must be"),
                    ((good, 3), dict(query_vec=vecs[0], deadline_s=0.0),
                     "deadline_s"),
                    ((good, 3), {}, "encoder")):
                with pytest.raises(ValueError, match=match):
                    pipe.submit(*args, **kw)
            got[pkg] = (outs, pipe.stats())
        finally:
            pipe.close()
    (jouts, jst), (touts, tst) = got["jax"], got["port"]
    assert touts == jouts
    assert 5 in touts[0][1] and touts[0][1] == sorted(set(touts[0][1]))
    assert list(tst) == list(jst)
    for key in ("submitted", "completed", "failed", "expired", "rejected",
                "inflight", "k", "page_size", "prefix_hits",
                "prefix_tokens_reused"):
        assert tst[key] == jst[key], key
    assert tst["prefix_hits"] > 0
    assert list(tst["tiers"]["knn"]) == list(jst["tiers"]["knn"])
    assert list(tst["tiers"]["generate"]) == list(jst["tiers"]["generate"])


# ---------------------------------------------------------------------------
# two-tier pipeline drills (slow, as JAX's TestRagPipeline)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rag(lms):
    _jnet, tnet = lms
    vecs, passages = corpus()
    pipe = port_pipeline(tnet, vecs, passages)
    yield pipe
    pipe.close()


@pytest.mark.slow
class TestRagPipeline:
    def test_greedy_bit_exact_vs_non_rag_reference(self, rag, lms):
        _jnet, tnet = lms
        vecs, passages = corpus()
        prompt = np.random.RandomState(7).randint(1, V, 5)
        fut = rag.submit(prompt, 6, query_vec=vecs[5] + 0.01)
        out = fut.result(timeout=TIMEOUT)
        assert 5 in fut._rag_docs
        ref_prompt, _o, plen = assemble_passage_prefix(
            fut._rag_docs, passages, page_size=PS, query_ids=prompt)
        np.testing.assert_array_equal(fut._rag_prompt, ref_prompt)
        assert plen == fut._rag_prefix_len
        ref = zoo.greedy_generate(tnet, fut._rag_prompt[None], 6, V)[0]
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_sampled_bit_exact_vs_non_rag_reference(self, rag, lms):
        _jnet, tnet = lms
        vecs, _passages = corpus()
        prompt = np.random.RandomState(8).randint(1, V, 4)
        fut = rag.submit(prompt, 5, query_vec=vecs[9] - 0.01,
                         temperature=0.8, top_k=5, seed=11)
        out = fut.result(timeout=TIMEOUT)
        ref = zoo.sample_generate(tnet, fut._rag_prompt[None], 5, V,
                                  temperature=0.8, top_k=5, seed=11)[0]
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_hot_documents_dedupe_prefill(self, rag):
        vecs, _passages = corpus()
        rs = np.random.RandomState(9)
        before = rag.stats()
        futs = [rag.submit(rs.randint(1, V, 5), 4, query_vec=vecs[21])
                for _ in range(6)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        assert all(f._rag_docs == futs[0]._rag_docs for f in futs)
        assert all(np.asarray(o).shape == (4,) for o in outs)
        st = rag.stats()
        assert st["prefix_hits"] > before["prefix_hits"]
        assert st["prefix_tokens_reused"] > before["prefix_tokens_reused"]
        assert st["inflight"] == 0
        assert st["submitted"] == (st["completed"] + st["failed"]
                                   + st["expired"] + st["rejected"])

    def test_deadline_propagates_across_tiers_typed(self, rag):
        vecs, _passages = corpus()
        before = rag.stats()["expired"]
        prompt = np.array([1, 2, 3, 4, 5], np.int64)
        f = rag.submit(prompt, 3, query_vec=vecs[40], deadline_s=0.001)
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=TIMEOUT)
        assert rag.stats()["expired"] == before + 1
        ok = rag.submit(prompt, 3, query_vec=vecs[40])
        assert np.asarray(ok.result(timeout=TIMEOUT)).shape == (3,)

    def test_admission_watermark_sheds_typed(self, rag):
        vecs, _passages = corpus()
        before = rag.stats()
        free = rag.admission.max_pending - rag.admission.pending
        for _ in range(free):
            rag.admission.acquire()
        try:
            with pytest.raises(ServerOverloaded):
                rag.submit(np.array([1, 2], np.int64), 3,
                           query_vec=vecs[0])
        finally:
            for _ in range(free):
                rag.admission.release()
        st = rag.stats()
        assert st["submitted"] == before["submitted"]
        assert st["rejected"] == before["rejected"]
        f = rag.submit(np.array([1, 2], np.int64), 3, query_vec=vecs[0])
        assert np.asarray(f.result(timeout=TIMEOUT)).shape == (3,)

    def test_metrics_sources_carry_tier_labels(self, rag):
        labels = [lbl for lbl, _reg in rag.metrics_sources()]
        assert labels == [{}, {}, {"tier": "knn"}, {"tier": "generate"}]

    def test_tier_stats_and_slot_lever(self, rag):
        for role in ("knn", "generate"):
            st = rag.tier_stats(role)
            assert st["replicas"] == 1 and st["slots"] > 0
        cap = rag.tier_stats("generate")["slots"]
        assert rag.set_tier_active_slots("generate", 1) == 1
        try:
            assert rag.tier_stats("generate")["active_slots"] <= 1
        finally:
            rag.set_tier_active_slots("generate", cap)

    def test_close_idempotent_and_submit_after_close(self, lms):
        _jnet, tnet = lms
        vecs, passages = corpus()
        pipe = port_pipeline(tnet, vecs, passages, slots=2)
        f = pipe.submit(np.array([1, 2, 3], np.int64), 3,
                        query_vec=vecs[3])
        pipe.close()
        pipe.close()
        assert f.done()
        with pytest.raises(RuntimeError, match="closed"):
            pipe.submit(np.array([1], np.int64), 2, query_vec=vecs[0])


# ---------------------------------------------------------------------------
# /rag HTTP route (slow, as JAX's TestRagRoute)
# ---------------------------------------------------------------------------

@pytest.mark.slow
class TestRagRoute:
    def test_rag_route_end_to_end(self, lms):
        from deeplearning4j_torch.modelimport.server import (
            KerasBackendServer)

        _jnet, tnet = lms
        vecs, passages = corpus()
        srv = KerasBackendServer()
        mid = srv.attach_rag(tnet, vocab=V, passages=passages,
                             doc_vectors=vecs, k=2, slots=2, page_size=PS,
                             mid="rag0", device="cpu")
        port = srv.start()
        base = f"http://127.0.0.1:{port}"
        try:
            body = json.dumps({
                "model": mid, "prompt_ids": [1, 2, 3], "max_tokens": 4,
                "query_vec": [float(x) for x in vecs[12]],
            }).encode()
            req = urllib.request.Request(
                base + "/rag", body, {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as res:
                out = json.loads(res.read())
            assert len(out["tokens"]) == 4
            assert 12 in out["docs"]
            assert out["prefix_len"] % PS == 0
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=TIMEOUT) as res:
                text = res.read().decode()
            assert 'rag_completed_total{model="rag0"} 1' in text
            assert 'rag_ttft_ms_count{model="rag0"} 1' in text
            assert 'rag_e2e_ms_count{model="rag0"} 1' in text
            assert f'knn_points{{model="rag0",tier="knn"}} {NDOCS}' in text
            assert 'knn_recall{model="rag0",tier="knn"}' in text
            assert 'generation_slots{model="rag0",tier="generate"} 2' \
                in text
            with urllib.request.urlopen(base + "/stats",
                                        timeout=TIMEOUT) as res:
                stats = json.loads(res.read())
            assert stats["rag"][mid]["completed"] == 1
        finally:
            srv.stop()
