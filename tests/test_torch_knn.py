"""Port parity: the retrieval stores (the port's ``nearestneighbors/
{brute,index,hnsw}.py``) against the JAX package's, on the CPU — the
counterpart of ``tests/test_knn_serve.py`` without its mesh classes
(``TestMeshSharded``, ``TestShardedIVF``: ``tests/test_torch_sharded_knn.py``
holds those).

Tolerances and the tie rule:

- Inside the port the f32 ``EmbeddingIndex`` is bitwise
  ``DeviceBruteForceIndex`` (one function on one device), and a coalesced
  row is bitwise the synchronous search of the same batch.
- Across packages the products round differently (MKL against XLA's CPU
  dot) and ``torch.topk`` promises no order among equal distances. The
  euclidean distance is ``sqrt(||q||^2 - 2 q.p + ||p||^2)``, whose rounding
  error scales with the norms, not with the distance: squared distances
  agree within ``SQ_REL`` (2^-20) times ``max||q||^2 + max||p||^2``, cosine
  distances within ``DIST_ATOL`` (1e-4); ids agree at every rank whose
  float64 distance is apart from both neighbouring ranks' by more than
  that tolerance (``assert_knn_close``, the tie rule).
- Host-built arrays (the int8 codes, scales and norms, the HNSW graph and
  its answers, the IVF list layout given the same centroids) equal JAX's
  bit for bit; k-means centroids within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.metrics.exposition import (  # noqa: E402
    render_text as jrender)
from deeplearning4j_tpu.nearestneighbors import index as jindex  # noqa
from deeplearning4j_tpu.nearestneighbors.brute import (  # noqa: E402
    DeviceBruteForceIndex as JBrute)
from deeplearning4j_tpu.nearestneighbors.hnsw import (  # noqa: E402
    HNSWGraph as JHNSW)
from deeplearning4j_torch.metrics.exposition import render_text  # noqa
from deeplearning4j_torch.nearestneighbors import index as tindex  # noqa
from deeplearning4j_torch.nearestneighbors.brute import (  # noqa: E402
    DeviceBruteForceIndex)
from deeplearning4j_torch.nearestneighbors.hnsw import HNSWGraph  # noqa
from deeplearning4j_torch.nearestneighbors.index import (  # noqa: E402
    EmbeddingIndex)
from deeplearning4j_torch.parallel.resilience import (  # noqa: E402
    ChaosPolicy, CircuitBreaker, CircuitOpen, DeadlineExceeded, RetryPolicy,
    ServerOverloaded)

pytestmark = pytest.mark.torch_port

DIST_ATOL = 1e-4
SQ_REL = 2.0 ** -20
TIMEOUT = 60


def corpus(n, d, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def clustered(n, d, centers=128, seed=0, scale=4.0, noise=0.6):
    """``tests/test_knn_serve.py::_clustered``: a mixture of gaussians."""
    rs = np.random.RandomState(seed)
    mu = rs.randn(centers, d).astype(np.float32) * scale
    pts = mu[rs.randint(0, centers, n)] + rs.randn(n, d).astype(
        np.float32) * noise
    return pts.astype(np.float32)


def near_rows(pts, q, seed):
    rs = np.random.RandomState(seed)
    return (pts[rs.choice(len(pts), q, replace=False)]
            + rs.randn(q, pts.shape[1]).astype(np.float32) * 0.2)


def idx_kw(**kw):
    return dict(kw, device="cpu")


def exact_sorted(pts, qs, metric):
    """Every query's distances to every point in float64, ascending
    (squared for euclidean)."""
    p, q = pts.astype(np.float64), qs.astype(np.float64)
    if metric == "cosine":
        p = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-12)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        d = np.maximum(1.0 - q @ p.T, 0.0)
    else:
        d = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    return np.sort(d, axis=1)


def assert_knn_close(got, want, pts, qs, metric):
    """The tie rule: (squared, for euclidean) distances within the stated
    tolerance; ids equal at every rank whose exact distance is more than
    that from both neighbouring ranks'. ``pts`` are the vectors the store
    holds (dequantized for int8). Returns the count of ranks left
    unchecked."""
    (dg, ig), (dw, iw) = got, want
    assert dg.shape == dw.shape and ig.shape == iw.shape
    if metric == "cosine":
        tol = DIST_ATOL
    else:
        tol = SQ_REL * float(np.max(np.sum(qs * qs, 1))
                             + np.max(np.sum(pts * pts, 1)))
        dg, dw = dg.astype(np.float64) ** 2, dw.astype(np.float64) ** 2
    np.testing.assert_allclose(dg, dw, atol=tol, rtol=0)
    ref = exact_sorted(pts, qs, metric)
    k = dg.shape[1]
    pad = np.full((ref.shape[0], 1), np.inf)
    full = np.concatenate([-pad, ref, pad], axis=1)
    gap = np.minimum(full[:, 1:k + 1] - full[:, :k],
                     full[:, 2:k + 2] - full[:, 1:k + 1])
    clear = gap > tol
    np.testing.assert_array_equal(ig[clear], iw[clear])
    return int((~clear).sum())


# ---------------------------------------------------------------------------
# exact parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_f32_index_bitwise_brute_and_close_to_jax(metric):
    pts = corpus(257, 12, seed=1)
    qs = corpus(19, 12, seed=2)
    brute = DeviceBruteForceIndex(pts, metric=metric, device="cpu")
    jbrute = JBrute(pts, metric=metric)
    with EmbeddingIndex(pts, metric, **idx_kw()) as index:
        for k in (1, 3, 7):
            db, ib = brute.search_batch_arrays(qs, k)
            de, ie = index.search_batch_arrays(qs, k)
            assert np.array_equal(db, de) and np.array_equal(ib, ie)
            assert ie.dtype == np.int32
            assert_knn_close((de, ie), jbrute.search_batch_arrays(qs, k),
                             pts, qs, metric)
        assert index.search(qs[0], 3) == brute.search(qs[0], 3)
        assert [i for _, i in index.search(qs[0], 3)] == \
            [i for _, i in jbrute.search(qs[0], 3)]


def test_k_clamp_and_typed_errors_as_jax():
    pts = corpus(10, 4)
    brute = DeviceBruteForceIndex(pts, device="cpu")
    with EmbeddingIndex(pts, **idx_kw()) as index:
        db, ib = brute.search_batch_arrays(pts[:3], 999)
        de, ie = index.search_batch_arrays(pts[:3], 999)
        assert db.shape == de.shape == (3, 10)
        assert np.array_equal(ib, ie)
        np.testing.assert_array_equal(
            ie, JBrute(pts).search_batch_arrays(pts[:3], 999)[1])
        for bad_k in (0, -2, 2.5, "x", True):
            with pytest.raises(ValueError):
                brute.search_batch_arrays(pts[:2], bad_k)
            with pytest.raises(ValueError):
                index.search_batch_arrays(pts[:2], bad_k)
        with pytest.raises(ValueError, match="dims mismatch"):
            index.search_batch_arrays(np.zeros((2, 5), np.float32), 3)
    with EmbeddingIndex(**idx_kw()) as empty:
        with pytest.raises(ValueError, match="empty"):
            empty.search_batch_arrays(np.zeros((1, 4), np.float32), 1)
    with pytest.raises(ValueError, match="metric"):
        DeviceBruteForceIndex(pts, metric="l1", device="cpu")


def test_ctor_validation_and_a9_refusals():
    pts = corpus(64, 8)
    with pytest.raises(ValueError, match="store"):
        EmbeddingIndex(pts, store="float16", **idx_kw())
    with pytest.raises(ValueError, match="hnsw"):
        EmbeddingIndex(pts, store="hnsw", partitions=8, **idx_kw())
    with pytest.raises(ValueError, match="kmeans"):
        EmbeddingIndex(pts, kmeans="spherical", **idx_kw())
    for bad in (0, -3):
        with pytest.raises(ValueError, match="nprobe must be >= 1"):
            EmbeddingIndex(pts, partitions=8, nprobe=bad, **idx_kw())
    # the mesh paths are ported (they named ROADMAP A9 before): a mesh
    # of another type is refused, sharded k-means needs a mesh (JAX's
    # ValueError), and a host mesh builds each store
    from deeplearning4j_torch.parallel.mesh import Mesh

    for kw in (dict(mesh=object()), dict(mesh=object(), kmeans="sharded")):
        with pytest.raises(TypeError, match="Mesh"):
            EmbeddingIndex(pts, **idx_kw(**kw))
    with pytest.raises(ValueError, match="sharded"):
        EmbeddingIndex(pts, **idx_kw(partitions=8, kmeans="sharded"))
    mesh = Mesh([torch.device("cpu")] * 2, ("data",))
    for kw, variant in ((dict(), "aux"), (dict(store="int8"), "int8"),
                        (dict(partitions=4, kmeans="sharded"), "ivf")):
        with EmbeddingIndex(pts, mesh=mesh, **kw) as index:
            assert index.stats()["variant"] == variant


def test_entry_points_run_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = corpus(16, 4)
    for make in (lambda: EmbeddingIndex(pts),
                 lambda: EmbeddingIndex(pts, store="int8"),
                 lambda: DeviceBruteForceIndex(pts)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------------------
# the coalescer
# ---------------------------------------------------------------------------

def test_32_one_row_submits_are_one_dispatch_bitwise():
    """32 concurrent one-row submits are ONE dispatch of the 32-row bucket,
    each caller's slice bitwise the synchronous batched answer (as JAX's
    ``test_32_one_row_submits_are_one_dispatch_bit_exact``)."""
    pts = corpus(300, 8, seed=3)
    qs = corpus(32, 8, seed=4)
    with EmbeddingIndex(pts, max_batch=32, max_wait_ms=10_000.0,
                        **idx_kw()) as index:
        d_sync, i_sync = index.search_batch_arrays(qs, 5)
        before = index.stats()["dispatches"]
        futs = [index.submit(qs[i:i + 1], 5) for i in range(32)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        assert index.stats()["dispatches"] == before + 1
        for i, (d, ix) in enumerate(outs):
            assert np.array_equal(d, d_sync[i:i + 1])
            assert np.array_equal(ix, i_sync[i:i + 1])
        st = index.stats()
        assert st["completed"] == 32 and st["failed"] == 0
        assert st["pending"] == 0


def test_batch_churn_stays_in_the_pow2_program_budget():
    pts = corpus(200, 6, seed=5)
    with EmbeddingIndex(pts, **idx_kw()) as index:
        rs = np.random.RandomState(0)
        for _ in range(40):
            q = corpus(int(rs.randint(1, 64)), 6, seed=int(rs.randint(99)))
            index.search_batch_arrays(q, 8)
        assert index.stats()["programs"] <= 7
        assert set(index._programs) <= {("exact", b, 8)
                                        for b in (1, 2, 4, 8, 16, 32, 64)}


def test_mixed_k_submits_resolve_with_right_widths():
    pts = corpus(100, 5, seed=6)
    with EmbeddingIndex(pts, max_wait_ms=5.0, **idx_kw()) as index:
        ks = [1, 3, 4, 7, 8]
        futs = [index.submit(corpus(2, 5, seed=i), k)
                for i, k in enumerate(ks)]
        for i, (f, k) in enumerate(zip(futs, ks)):
            d, idx = f.result(timeout=TIMEOUT)
            assert d.shape == (2, k) and idx.shape == (2, k)
            sd, si = index.search_batch_arrays(corpus(2, 5, seed=i), k)
            np.testing.assert_array_equal(idx, si)


# ---------------------------------------------------------------------------
# int8 store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_int8_store_bitwise_jax_arrays_and_answers(metric):
    """The codes, scales and reconstructed norms are host arithmetic: bitwise
    JAX's. The answers follow the tie rule; recall equals JAX's."""
    pts = corpus(2048, 16, seed=7)
    qs = corpus(64, 16, seed=8)
    q, s = tindex._quantize_rows(pts)
    jq, js = jindex._quantize_rows(pts)
    assert q.dtype == np.int8 and np.array_equal(q, jq)
    assert np.array_equal(s, js)
    jx = jindex.EmbeddingIndex(pts, metric, store="int8")
    with EmbeddingIndex(pts, metric, store="int8", **idx_kw()) as tx:
        for ta, ja in zip(tx._store.arrays, jx._store.arrays):
            assert np.array_equal(ta.numpy(), np.asarray(ja))
        assert tx.resident_bytes == jx.resident_bytes
        assert_knn_close(tx.search_batch_arrays(qs, 10),
                         jx.search_batch_arrays(qs, 10),
                         q.astype(np.float32) * s[:, None], qs, metric)
        recall = tx.measure_recall(qs, k=10)
        assert recall == pytest.approx(jx.measure_recall(qs, k=10),
                                       abs=2 / 640)
        assert recall >= 0.9
        assert tx.stats()["recall"] == pytest.approx(recall)
    jx.close()


def test_int8_capacity_ratio_and_bitwise_rebuild_after_drain_close():
    pts = corpus(500, 16, seed=3)
    qs = corpus(16, 16, seed=9)
    with EmbeddingIndex(pts, **idx_kw()) as f32, \
            EmbeddingIndex(pts, store="int8", **idx_kw()) as q8:
        assert f32.resident_bytes / q8.resident_bytes >= 1.8
    first = EmbeddingIndex(pts, store="int8", **idx_kw())
    first.submit(qs[:4], 5).result(timeout=TIMEOUT)
    d1, i1 = first.search_batch_arrays(qs, 10)
    assert first.drain(timeout=30)
    d_mid, i_mid = first.search_batch_arrays(qs, 10)
    assert np.array_equal(d1, d_mid) and np.array_equal(i1, i_mid)
    first.close()
    with EmbeddingIndex(pts, store="int8", **idx_kw()) as second:
        d2, i2 = second.search_batch_arrays(qs, 10)
    assert np.array_equal(d1, d2) and np.array_equal(i1, i2)


# ---------------------------------------------------------------------------
# IVF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["f32", "int8"])
def test_ivf_layout_equals_jax_given_equal_centroids(store):
    """On well-separated clusters both packages' k-means land on the same
    centroids (within 1e-5) and assignments, so the list layout (ids),
    list length and spill count are JAX's, and the host-built lists
    (vectors or codes, scales, norms) bitwise."""
    pts = clustered(1024, 8, centers=16, seed=11, scale=12.0, noise=0.3)
    kw = dict(store=store, partitions=16, nprobe=4, kmeans_iters=10,
              seed=0)
    jx = jindex.EmbeddingIndex(pts, **kw)
    with EmbeddingIndex(pts, **idx_kw(**kw)) as tx:
        ta, ja = tx._store.arrays, jx._store.arrays
        np.testing.assert_allclose(ta[0].numpy(), np.asarray(ja[0]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ta[5].numpy(), np.asarray(ja[5]))
        for t, j in zip(ta[2:5], ja[2:5]):
            if j is None:
                assert t is None
            else:
                assert np.array_equal(t.numpy(), np.asarray(j))
        st, sj = tx.stats(), jx.stats()
        for key in ("variant", "partitions", "list_len", "nprobe",
                    "spilled", "resident_bytes", "probe_local"):
            assert st[key] == sj[key], key
        qs = near_rows(pts, 16, seed=12)
        held = pts
        if store == "int8":
            q, s = tindex._quantize_rows(pts)
            held = q.astype(np.float32) * s[:, None]
        assert_knn_close(tx.search_batch_arrays(qs, 5),
                         jx.search_batch_arrays(qs, 5), held, qs,
                         "euclidean")
    jx.close()


def test_ivf_recall_gate_on_clustered_corpus():
    pts = clustered(4096, 16, seed=0)
    qs = near_rows(pts, 64, seed=1)
    with EmbeddingIndex(pts, partitions=64, nprobe=8, kmeans_iters=10,
                        seed=0, **idx_kw()) as index:
        st = index.stats()
        assert st["variant"] == "ivf" and st["partitions"] == 64
        assert index.measure_recall(qs, k=10) >= 0.95


def test_int8_ivf_composes():
    pts = clustered(2048, 16, seed=2)
    qs = near_rows(pts, 32, seed=3)
    with EmbeddingIndex(pts, store="int8", partitions=32, nprobe=8,
                        kmeans_iters=10, seed=0, **idx_kw()) as index:
        assert index.measure_recall(qs, k=10) >= 0.9
        d, idx = index.search_batch_arrays(qs, 5)
        assert d.shape == (32, 5)
        assert (idx >= 0).all() and (idx < 2048).all()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_full_probe_answers_as_the_exact_store(metric):
    """Over-probing clamps to the partition count, and a full probe IS an
    exact search: ids equal to the exact store's under the tie rule,
    distances within DIST_ATOL (the cheap tier-1 sibling of the JAX-side
    slow case below)."""
    pts = clustered(512, 16, seed=20)
    qs = near_rows(pts, 16, seed=21)
    with EmbeddingIndex(pts, metric, **idx_kw()) as exact, \
            EmbeddingIndex(pts, metric, partitions=16, nprobe=99,
                           kmeans_iters=10, seed=0, **idx_kw()) as ivf:
        assert ivf.stats()["nprobe"] == 16
        assert_knn_close(ivf.search_batch_arrays(qs, 10),
                         exact.search_batch_arrays(qs, 10), pts, qs, metric)


@pytest.mark.slow
def test_full_probe_parity_against_jax():
    """JAX's ``test_nprobe_above_partitions_clamps_to_full_probe_parity``
    on both packages: each full probe answers as the JAX exact index."""
    pts = clustered(512, 16, seed=20)
    qs = near_rows(pts, 16, seed=21)
    want = JBrute(pts).search_batch_arrays(qs, 10)
    jivf = jindex.EmbeddingIndex(pts, partitions=16, nprobe=99,
                                 kmeans_iters=10, seed=0)
    with EmbeddingIndex(pts, partitions=16, nprobe=99, kmeans_iters=10,
                        seed=0, **idx_kw()) as ivf:
        for got in (ivf.search_batch_arrays(qs, 10),
                    jivf.search_batch_arrays(qs, 10)):
            assert_knn_close(got, want, pts, qs, "euclidean")
    jivf.close()


# ---------------------------------------------------------------------------
# HNSW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_hnsw_bitwise_jax(metric):
    pts = clustered(400, 8, centers=16, seed=22)
    qs = near_rows(pts, 12, seed=23)
    jg = JHNSW(pts, metric=metric, m=8, ef_construction=32, seed=1)
    tg = HNSWGraph(pts, metric=metric, m=8, ef_construction=32, seed=1)
    assert tg.levels == jg.levels and tg.nbytes == jg.nbytes
    for a, b in zip(tg._nbr, jg._nbr):
        assert np.array_equal(a, b)
    for a, b in zip(tg.search_batch(qs, 5, ef=16),
                    jg.search_batch(qs, 5, ef=16)):
        assert np.array_equal(a, b)
    kw = dict(store="hnsw", hnsw_m=8, ef_construction=32, ef_search=16)
    jx = jindex.EmbeddingIndex(pts, metric, **kw)
    with EmbeddingIndex(pts, metric, **idx_kw(**kw)) as tx:
        for a, b in zip(tx.search_batch_arrays(qs, 5),
                        jx.search_batch_arrays(qs, 5)):
            assert np.array_equal(a, b)
        fut = tx.submit(qs[:2], 5)
        for a, b in zip(fut.result(timeout=TIMEOUT),
                        jx.search_batch_arrays(qs[:2], 5)):
            assert np.array_equal(a, b)
        st, sj = tx.stats(), jx.stats()
        for key in ("variant", "hnsw_m", "ef_search", "levels",
                    "resident_bytes"):
            assert st[key] == sj[key], key
    jx.close()


@pytest.mark.slow
def test_hnsw_recall_gate_and_stats():
    pts = clustered(2048, 16, seed=22)
    qs = near_rows(pts, 32, seed=23)
    with EmbeddingIndex(pts, store="hnsw", hnsw_m=32, ef_construction=128,
                        ef_search=128, **idx_kw()) as index:
        st = index.stats()
        assert st["variant"] == "hnsw" and st["hnsw_m"] == 32
        assert st["levels"] >= 1
        assert index.measure_recall(qs, k=10) >= 0.95
        d, idx = index.search_batch_arrays(qs, 5)
        assert d.shape == (32, 5)
        assert (idx >= 0).all() and (idx < 2048).all()


# ---------------------------------------------------------------------------
# typed failures, lifecycle, fleet
# ---------------------------------------------------------------------------

def test_expired_deadline_is_deadline_exceeded():
    pts = corpus(100, 4)
    with EmbeddingIndex(pts, max_wait_ms=1.0, **idx_kw()) as index:
        fut = index.submit(pts[:1], 3, deadline_s=1e-6)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert index.stats()["expired"] >= 1


def test_burst_beyond_watermark_sheds_typed():
    pts = corpus(100, 4)
    chaos = ChaosPolicy(seed=0, latency_rate=1.0, latency_s=0.05)
    with EmbeddingIndex(pts, max_batch=4, max_wait_ms=1.0, inflight=1,
                        max_pending=8, chaos=chaos, **idx_kw()) as index:
        admitted, shed = [], 0
        for i in range(40):
            try:
                admitted.append(index.submit(corpus(1, 4, seed=i), 3))
            except ServerOverloaded:
                shed += 1
        assert shed > 0
        for f in admitted:
            d, _ = f.result(timeout=TIMEOUT)
            assert d.shape == (1, 3)
        st = index.stats()
        assert st["rejected"] == shed and st["pending"] == 0


def test_open_breaker_fast_fails_submits():
    pts = corpus(100, 4)
    breaker = CircuitBreaker(failure_threshold=0.5, window=8, min_calls=2,
                             reset_timeout_s=60.0)
    with EmbeddingIndex(pts, max_wait_ms=1.0,
                        chaos=ChaosPolicy(seed=0, hard_rate=1.0),
                        breaker=breaker, retry=RetryPolicy(max_attempts=1),
                        **idx_kw()) as index:
        saw_open = False
        for _ in range(12):
            try:
                fut = index.submit(pts[:1], 3)
            except CircuitOpen:
                saw_open = True
                break
            with pytest.raises(RuntimeError):
                fut.result(timeout=30)
        assert saw_open or breaker.state == CircuitBreaker.OPEN
        with pytest.raises(CircuitOpen):
            index.submit(pts[:1], 3)
        st = index.stats()
        assert st["breaker_state"] == "open"
        assert st["rejected_circuit"] >= 1


def test_close_with_inflight_loses_zero_futures():
    pts = corpus(200, 6)
    chaos = ChaosPolicy(seed=0, latency_rate=1.0, latency_s=0.02)
    index = EmbeddingIndex(pts, max_batch=4, max_wait_ms=1.0, inflight=1,
                           chaos=chaos, **idx_kw())
    futs = [index.submit(corpus(1, 6, seed=i), 3) for i in range(16)]
    index.close()
    resolved = failed = 0
    for f in futs:
        assert f.done(), "close() left a future unresolved"
        if f.exception() is None:
            assert f.result()[0].shape == (1, 3)
            resolved += 1
        else:
            failed += 1
    assert resolved + failed == 16
    st = index.stats()
    assert st["pending"] == 0
    assert st["completed"] + st["failed"] == st["accepted"]


def test_submit_after_close_and_idempotent_close():
    index = EmbeddingIndex(corpus(50, 4), **idx_kw())
    index.submit(corpus(1, 4), 3).result(timeout=TIMEOUT)
    index.close()
    index.close()
    with pytest.raises(RuntimeError, match="closed"):
        index.submit(corpus(1, 4), 3)
    with pytest.raises(RuntimeError, match="closed"):
        index.add(corpus(1, 4))


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_add_and_add_documents_grow_the_store(store):
    pts = corpus(50, 4, seed=20)
    with EmbeddingIndex(pts, store=store, **idx_kw()) as index:
        assert index.n_points == 50
        extra = corpus(10, 4, seed=21)
        assert index.add(extra) == 60
        d, idx = index.search_batch_arrays(extra[:1], 1)
        assert idx[0, 0] == 50
        assert d[0, 0] == pytest.approx(0.0, abs=2e-2)
        with pytest.raises(ValueError, match="dims mismatch"):
            index.add(corpus(2, 5))
    doubled = EmbeddingIndex(encoder=lambda x: np.concatenate([x, x], 1),
                             **idx_kw())
    vecs = doubled.add_documents(corpus(3, 2, seed=4))
    assert vecs.shape == (3, 4) and doubled.n_points == 3
    np.testing.assert_array_equal(doubled.encode(corpus(3, 2, seed=4)),
                                  vecs)
    doubled.close()


def test_index_replicas_ride_the_fleet_and_slot_lever():
    from deeplearning4j_torch.parallel.fleet import ReplicaFleet

    pts = corpus(100, 4, seed=22)
    fleet = ReplicaFleet(
        lambda rid: EmbeddingIndex(pts, max_wait_ms=1.0, **idx_kw()),
        replicas=2)
    try:
        futs = [fleet.submit(pts[i:i + 1], 3) for i in range(8)]
        for i, f in enumerate(futs):
            _d, idx = f.result(timeout=TIMEOUT)
            assert idx[0, 0] == i
    finally:
        fleet.close()
    with EmbeddingIndex(pts, max_batch=16, **idx_kw()) as index:
        assert index.active_slot_cap == 16
        assert index.set_active_slots(99) == 16
        assert index.set_active_slots(0) == 1 and index.max_batch == 1


# ---------------------------------------------------------------------------
# stats and metric families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(store="int8"),
                                dict(partitions=4, kmeans_iters=3),
                                dict(store="hnsw", hnsw_m=4)])
def test_stats_keys_and_families_equal_jax(kw):
    pts = clustered(64, 4, centers=4, seed=30)
    qs = corpus(3, 4, seed=31)
    outs = []
    for make in (lambda: jindex.EmbeddingIndex(pts, **kw),
                 lambda: EmbeddingIndex(pts, **idx_kw(**kw))):
        index = make()
        try:
            for i in range(3):
                index.submit(qs[i:i + 1], 2).result(timeout=TIMEOUT)
            index.measure_recall(qs, k=2)
        finally:
            index.close()
        outs.append(index)
    (jx, tx) = outs
    js, ts = jx.stats(), tx.stats()
    assert list(ts) == list(js)
    for key in ("completed", "failed", "points", "dims", "store", "variant",
                "resident_bytes", "accepted", "rejected", "pending",
                "breaker_state", "queued", "slots"):
        assert ts[key] == js[key], key

    def families(text):
        return [ln for ln in text.splitlines() if ln.startswith("# ")]

    assert families(render_text([({}, tx.metrics)])) == \
        families(jrender([({}, jx.metrics)]))
