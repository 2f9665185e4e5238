"""Port parity: the mesh-sharded retrieval stores (the port's
``nearestneighbors/index.py`` with ``mesh=``) against the JAX package's, on
the CPU — the counterpart of ``tests/test_knn_serve.py``'s
``TestMeshSharded`` and ``TestShardedIVF``. JAX shards over its eight XLA
CPU devices (``data_mesh(8)``); the port over a host mesh that names the
CPU eight times, each entry with tensors of its own.

Tolerances:

- The sharded flat store's ids equal the unsharded store's exactly, its
  distances within 1e-5 (JAX's gate, ``rtol=atol=1e-5``). Equal distances
  go to the lower global row id, as ``lax.top_k`` orders them.
- Against JAX's sharded store, answers hold by the tie rule of
  ``tests/test_torch_knn.py::assert_knn_close``.
- Recall gates are JAX's: int8 >= 0.9, sharded k-means IVF >= 0.95,
  probe-local >= global probe and >= 0.9. Sharded k-means centroids are
  within 1e-4 of JAX's (f32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.nearestneighbors.index import (  # noqa: E402
    EmbeddingIndex as JIndex)
from deeplearning4j_tpu.parallel.mesh import data_mesh  # noqa: E402
from deeplearning4j_torch.nearestneighbors.index import (  # noqa: E402
    EmbeddingIndex)
from deeplearning4j_torch.parallel.mesh import Mesh, psum  # noqa: E402
from tests.test_torch_knn import (  # noqa: E402
    assert_knn_close, clustered, corpus, near_rows)

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def host_mesh(n=8):
    return Mesh([CPU] * n, ("data",))


def dequantized(index):
    """The vectors an int8 store holds, in row order."""
    q = torch.cat([sh[0] for sh in index._store.shards]).numpy()
    s = torch.cat([sh[1] for sh in index._store.shards]).numpy()
    return (q.astype(np.float32) * s[:, None])[:index.n_points]


# ---------------------------------------------------------------- flat
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_flat_agrees_with_unsharded(metric):
    """300 rows pad to 304 on 8 entries; ids equal, distances 1e-5."""
    pts = corpus(300, 8, seed=10)
    qs = corpus(9, 8, seed=11)
    with EmbeddingIndex(pts, metric, device="cpu") as plain, \
            EmbeddingIndex(pts, metric, mesh=host_mesh()) as shard:
        assert shard.stats()["variant"] == "aux"
        for k in (1, 7, 33):
            dp, ip = plain.search_batch_arrays(qs, k)
            ds, is_ = shard.search_batch_arrays(qs, k)
            assert np.array_equal(ip, is_)
            np.testing.assert_allclose(dp, ds, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_sharded_store_close_to_jax(store):
    pts = corpus(300, 8, seed=10)
    qs = corpus(9, 8, seed=11)
    jx = JIndex(pts, store=store, mesh=data_mesh(8))
    try:
        with EmbeddingIndex(pts, store=store, mesh=host_mesh()) as tx:
            held = pts if store == "f32" else dequantized(tx)
            assert_knn_close(tx.search_batch_arrays(qs, 7),
                             jx.search_batch_arrays(qs, 7), held, qs,
                             "euclidean")
            assert tx.stats()["variant"] == jx.stats()["variant"]
            assert tx.resident_bytes == jx.resident_bytes
    finally:
        jx.close()


def test_ties_go_to_the_lower_global_row():
    """Every row four times over, the copies on different entries: each
    query's k-NN lists the copies in row order, as the unsharded JAX
    store's ``lax.top_k`` does."""
    base = corpus(16, 4, seed=3)
    pts = np.concatenate([base] * 4)
    qs = base[[2, 9]] + 0.01
    jx = JIndex(pts)
    try:
        want = jx.search_batch_arrays(qs, 8)
    finally:
        jx.close()
    with EmbeddingIndex(pts, mesh=host_mesh(4)) as tx:
        d, i = tx.search_batch_arrays(qs, 8)
    assert np.array_equal(i, want[1])
    assert i[0, :4].tolist() == [2, 18, 34, 50]
    np.testing.assert_allclose(d, want[0], rtol=1e-5, atol=1e-5)


def test_sharded_int8_recall_and_coalesced_submits():
    pts = corpus(1024, 16, seed=12)
    qs = corpus(32, 16, seed=13)
    with EmbeddingIndex(pts, store="int8", mesh=host_mesh()) as index:
        assert index.measure_recall(qs, k=10) >= 0.9
        d, i = index.search_batch_arrays(qs[:4], 5)
        futs = [index.submit(qs[r], 5) for r in range(4)]
        rows = [f.result(timeout=60) for f in futs]
    assert np.array_equal(np.concatenate([r[1] for r in rows]), i)
    np.testing.assert_array_equal(np.concatenate([r[0] for r in rows]), d)


def test_entries_hold_their_share_of_the_rows():
    pts = corpus(300, 8, seed=10)
    with EmbeddingIndex(pts, store="int8", mesh=host_mesh(4)) as index:
        shards = index._store.shards
        assert [sh[0].shape[0] for sh in shards] == [75] * 4
        assert index.resident_bytes == sum(
            sum(a.numel() * a.element_size() for a in sh) for sh in shards)


# ----------------------------------------------------------------- IVF
def test_sharded_kmeans_recall_gate_and_centroids_close_to_jax():
    pts = clustered(2048, 16, seed=24)
    qs = near_rows(pts, 32, 25)
    kw = dict(kmeans="sharded", partitions=32, nprobe=8, kmeans_iters=10,
              seed=0)
    with EmbeddingIndex(pts, mesh=host_mesh(), **kw) as index:
        st = index.stats()
        assert st["variant"] == "ivf" and st["probe_local"] is True
        assert st["nprobe"] == 8 and st["partitions"] == 32
        recall = index.measure_recall(qs, k=10)
        assert recall >= 0.95, f"sharded-kmeans recall {recall} below gate"
        sample = pts[:512]
        mine = index._kmeans_sharded(sample, 16)
    jx = JIndex(pts[:64], mesh=data_mesh(8), **kw)
    try:
        np.testing.assert_allclose(mine, jx._kmeans_sharded(sample, 16),
                                   rtol=0, atol=1e-4)
    finally:
        jx.close()


def test_probe_local_recall_never_below_global_probe():
    pts = clustered(4096, 16, seed=26)
    qs = near_rows(pts, 32, 27)
    kw = dict(store="int8", partitions=64, nprobe=4, kmeans_iters=10,
              seed=0)
    with EmbeddingIndex(pts, mesh=host_mesh(), **kw) as local, \
            EmbeddingIndex(pts, device="cpu", **kw) as globl:
        assert local.stats()["probe_local"] is True
        assert globl.stats()["probe_local"] is False
        r_local = local.measure_recall(qs, k=10)
        r_global = globl.measure_recall(qs, k=10)
    assert r_local >= r_global
    assert r_local >= 0.9


def test_partitions_pad_to_the_mesh_and_nprobe_clamps():
    """30 cells on 8 entries pad to 32 with empty +inf-biased lists; an
    over-probe clamps at build as on one device."""
    pts = clustered(512, 8, seed=5)
    with EmbeddingIndex(pts, mesh=host_mesh(), partitions=30, nprobe=99,
                        kmeans_iters=5) as index:
        st = index.stats()
        assert st["nprobe"] == 30 and st["partitions"] == 30
        assert [sh[0].shape[0] for sh in index._store.shards] == [4] * 8
        pad = index._store.shards[-1]
        assert torch.isinf(pad[1][-2:]).all() and (pad[5][-2:] < 0).all()
        d, i = index.search_batch_arrays(pts[:3], 4)
        assert i[:, 0].tolist() == [0, 1, 2]
        assert np.isfinite(d).all()


def test_hnsw_with_a_mesh_is_refused_as_jax():
    pts = corpus(32, 4)
    with pytest.raises(ValueError, match="hnsw"):
        JIndex(pts, store="hnsw", mesh=data_mesh(2))
    with pytest.raises(ValueError, match="hnsw"):
        EmbeddingIndex(pts, store="hnsw", mesh=host_mesh(2))


def test_psum_sums_in_mesh_order_with_gradients():
    xs = [torch.full((3,), float(i), requires_grad=True) for i in range(4)]
    out = psum(xs)
    assert all(torch.equal(o, torch.full((3,), 6.0)) for o in out)
    sum(o.sum() * (j + 1) for j, o in enumerate(out)).backward()
    assert all(torch.equal(x.grad, torch.full((3,), 10.0)) for x in xs)
