"""Port parity: ``clustering/`` (the port's ``deeplearning4j_torch/
clustering``) against the JAX package's, on the CPU.

- ``KMeansClustering``: on a well-separated clustered set, with the same
  numpy ``default_rng`` init, the centroids are within ``CENTER_ATOL``
  (1e-5) of JAX's, the assignments equal, the cost within rtol 1e-5;
  ``predict`` equal; the Lloyd step itself within 1e-5 of JAX's on the
  same inputs.
- ``KDTree``, ``VPTree`` (``search``), ``SPTree`` and ``QuadTree`` are numpy
  copies: their results equal JAX's exactly.
- ``VPTree.search_batch`` (the brute-force batch on the device): ids equal
  and distances within ``DIST_ATOL`` (1e-4: f32 products of norms ~10
  round differently in the two packages' matmuls).
- ``KMeansClustering``'s device defaults to CUDA, and raises without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.clustering import kmeans as jkmeans  # noqa: E402
from deeplearning4j_tpu.clustering import (  # noqa: E402
    KDTree as JKDTree, KMeansClustering as JKMeans, QuadTree as JQuadTree,
    SPTree as JSPTree, VPTree as JVPTree)
from deeplearning4j_torch.clustering import kmeans as tkmeans  # noqa: E402
from deeplearning4j_torch.clustering import (  # noqa: E402
    KDTree, KMeansClustering, QuadTree, SPTree, VPTree)

pytestmark = pytest.mark.torch_port

CENTER_ATOL = 1e-5
DIST_ATOL = 1e-4


def separated(n=600, d=6, k=5, seed=0):
    """Clusters far apart against their spread: Lloyd lands on the same
    partition in both float orders."""
    rs = np.random.RandomState(seed)
    mu = rs.randn(k, d).astype(np.float32) * 10.0
    lab = rs.randint(0, k, n)
    return (mu[lab] + rs.randn(n, d).astype(np.float32) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 8), (2, 3)])
def test_kmeans_equals_jax(seed, k):
    x = separated(k=k, seed=seed)
    jk = JKMeans(k, max_iterations=50, seed=seed)
    tk = KMeansClustering(k, max_iterations=50, seed=seed, device="cpu")
    ja, ta = jk.apply_to(x), tk.apply_to(x)
    np.testing.assert_array_equal(np.asarray(ja), ta)
    np.testing.assert_allclose(tk.centers, jk.centers, atol=CENTER_ATOL,
                               rtol=0)
    assert tk.cost == pytest.approx(jk.cost, rel=1e-5)
    probe = separated(n=50, k=k, seed=seed + 10)
    np.testing.assert_array_equal(tk.predict(probe), jk.predict(probe))


def test_lloyd_step_equals_jax():
    x = separated(n=300, d=4, k=4, seed=3)
    c = x[[0, 50, 100, 150]]
    jc, ja, jcost = jkmeans._lloyd_iteration(x, c, k=4)
    tc, ta, tcost = tkmeans._lloyd_iteration(torch.as_tensor(x),
                                             torch.as_tensor(c), k=4)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    assert float(tcost) == pytest.approx(float(jcost), rel=1e-5)


def test_kmeans_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeansClustering(3)


def test_kdtree_equals_jax():
    rs = np.random.RandomState(4)
    pts = rs.randn(200, 3)
    jt, tt = JKDTree.build(pts), KDTree.build(pts)
    for q in rs.randn(10, 3):
        assert tt.knn(q, 5) == jt.knn(q, 5)
        assert tt.nn(q) == jt.nn(q)
    lo, hi = np.full(3, -0.5), np.full(3, 0.5)
    assert tt.range(lo, hi) == jt.range(lo, hi)
    ji, ti = JKDTree(2), KDTree(2)
    for p in rs.randn(50, 2):
        ji.insert(p)
        ti.insert(p)
    assert ti.size == ji.size == 50
    assert ti.knn([0.1, 0.2], 4) == ji.knn([0.1, 0.2], 4)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_vptree_equals_jax(metric):
    rs = np.random.RandomState(5)
    pts = rs.randn(300, 8)
    qs = rs.randn(7, 8)
    jt, tt = JVPTree(pts, metric=metric), VPTree(pts, metric=metric)
    for q in qs:
        assert tt.search(q, 6) == jt.search(q, 6)
    jb = jt.search_batch(qs, 6)
    tb = tt.search_batch(qs, 6, device="cpu")
    for jr, tr in zip(jb, tb):
        assert [i for _, i in tr] == [i for _, i in jr]
        np.testing.assert_allclose([d for d, _ in tr], [d for d, _ in jr],
                                   atol=DIST_ATOL)


def test_sptree_and_quadtree_equal_jax():
    rs = np.random.RandomState(6)
    for d, cls in ((3, (JSPTree, SPTree)), (2, (JQuadTree, QuadTree))):
        data = rs.randn(150, d)
        data[7] = data[3]                       # a stacked duplicate
        jt, tt = cls[0](data), cls[1](data)
        assert tt.is_correct() and jt.is_correct()
        assert tt.depth() == jt.depth()
        assert tt.cum_size == jt.cum_size == 150
        for i in (0, 3, 7, 99):
            jn, jq = jt.compute_non_edge_forces(i, 0.5)
            tn, tq = tt.compute_non_edge_forces(i, 0.5)
            np.testing.assert_array_equal(tn, jn)
            assert tq == jq
    with pytest.raises(ValueError, match="QuadTree"):
        QuadTree(rs.randn(5, 3))
