"""Port parity: t-SNE (the port's ``plot/tsne.py`` and ``plot/barnes_hut.py``)
against the JAX package's, on the CPU — with the cases of
``tests/test_barnes_hut.py`` run on the port.

Tolerances, and why:

- The kNN of ``build_sparse_p``: ids equal, squared distances within
  ``SQ_REL`` (2^-20) times ``2 max||x||^2`` (the expansion
  ``||a||^2 - 2 a.b + ||b||^2`` rounds relative to the norms).
- The perplexity search is the JAX package's numpy: bitwise on the same
  input. Fed the two packages' kNN distances it moves P by the rounding
  above, amplified by the bisection's stopping rule: edges equal, P within
  ``P_ATOL`` (1e-6; P's entries are ~1e-4 here) and summing to 1.
- One ladder repulsion and one gradient step on equal inputs: within
  ``STEP_RTOL`` (1e-5) of the largest value.
- t-SNE is chaotic: a rounding difference grows each step (about 2x a step
  once the embedding has spread, from 1e-8 at step 1), so fits are held
  for 5 iterations on the same P: y within ``FIT_RTOL`` (1e-4) of max|y|.
  ``Tsne``'s P is host numpy in both packages, hence equal; the
  ``BarnesHutTsne`` fit is fed JAX's P so only the steps differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu.plot.barnes_hut as jbh  # noqa: E402
import deeplearning4j_tpu.plot.tsne as jts  # noqa: E402
import deeplearning4j_torch.plot.barnes_hut as tbh  # noqa: E402
import deeplearning4j_torch.plot.tsne as tts  # noqa: E402
from deeplearning4j_torch.plot import (  # noqa: E402
    BarnesHutTsne, Tsne, build_sparse_p)

pytestmark = pytest.mark.torch_port

SQ_REL = 2.0 ** -20
P_ATOL = 1e-6
STEP_RTOL = 1e-5
FIT_RTOL = 1e-4


def two_clusters(n=60, d=10, seed=5, spread=0.3, gap=5.0):
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.randn(n, d) * spread,
                           rs.randn(n, d) * spread + gap]).astype(np.float32)


def test_knn_and_sparse_p_within_tolerance_of_jax():
    x = two_clusters()
    ti, td = tbh._knn(x, 20, device="cpu")
    ji, jd = jbh._knn(x, 20)
    np.testing.assert_array_equal(ti, ji)
    tol = SQ_REL * 2 * float(np.max(np.sum(x * x, 1)))
    np.testing.assert_allclose(td, jd, atol=tol, rtol=0)
    np.testing.assert_array_equal(tbh._perplexity_search(jd, 15.0),
                                  jbh._perplexity_search(jd, 15.0))
    tei, tej, tep = build_sparse_p(x, 15.0, device="cpu")
    jei, jej, jep = jbh.build_sparse_p(x, 15.0)
    np.testing.assert_array_equal(tei, jei)
    np.testing.assert_array_equal(tej, jej)
    np.testing.assert_allclose(tep, jep, atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(tep.sum(), 1.0, rtol=1e-6)
    n = x.shape[0]
    dense = np.zeros((n, n))
    np.add.at(dense, (tei, tej), tep)
    np.testing.assert_allclose(dense, dense.T, atol=1e-9)


def test_exact_p_and_step_equal_jax():
    x = two_clusters(n=30, d=5)
    d2 = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(tts._binary_search_p(d2, 9.0),
                                  jts._binary_search_p(d2, 9.0))
    rs = np.random.RandomState(0)
    n = x.shape[0]
    y = rs.randn(n, 2).astype(np.float32)
    P = np.abs(rs.rand(n, n)).astype(np.float32)
    P = (P + P.T) / (2 * P.sum())
    gains = np.ones_like(y)
    inc = (rs.randn(n, 2) * 0.1).astype(np.float32)
    jout = jts._tsne_step(y, P, gains, inc, np.float32(0.5),
                          np.float32(200.0))
    tout = tts._tsne_step(*(torch.as_tensor(a) for a in (y, P, gains, inc)),
                          0.5, 200.0)
    for t, j in zip(tout, jout):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j,
                                   atol=STEP_RTOL * np.abs(j).max(), rtol=0)


def test_ladder_repulsion_and_bh_step_equal_jax():
    rs = np.random.RandomState(0)
    y = (rs.randn(300, 2) * 5).astype(np.float32)
    R, l0, L = jbh._ladder_config(300, 0.5)
    assert tbh._ladder_config(300, 0.5) == (R, l0, L)
    jrep, jz = jbh._bh_repulsion(y, R=R, l0=l0, L=L)
    trep, tz = tbh._bh_repulsion(torch.as_tensor(y), R=R, l0=l0, L=L)
    for t, j in ((trep, jrep), (tz, jz)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j,
                                   atol=STEP_RTOL * np.abs(j).max(), rtol=0)
    x = two_clusters(n=150)
    ei, ej, ep = jbh.build_sparse_p(x, 15.0)
    y = (rs.randn(300, 2) * 2).astype(np.float32)
    gains = np.ones_like(y)
    inc = (rs.randn(300, 2) * 0.1).astype(np.float32)
    jout = jbh.make_bh_step(300, 0.5)(
        y.copy(), gains.copy(), inc.copy(), ei, ej,
        ep.astype(np.float32), np.float32(0.5), np.float32(200.0))
    tout = tbh.make_bh_step(300, 0.5)(
        torch.as_tensor(y), torch.as_tensor(gains), torch.as_tensor(inc),
        torch.as_tensor(ei, dtype=torch.int64),
        torch.as_tensor(ej, dtype=torch.int64),
        torch.as_tensor(ep, dtype=torch.float32), 0.5, 200.0)
    for t, j in zip(tout, jout):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j,
                                   atol=STEP_RTOL * np.abs(j).max(), rtol=0)


def test_fits_within_tolerance_of_jax(monkeypatch):
    x = two_clusters()
    kw = dict(perplexity=15, max_iter=5, learning_rate=200.0, seed=0)
    yj = jts.Tsne(**kw).fit(x)
    yt = Tsne(device="cpu", **kw).fit(x)
    np.testing.assert_allclose(yt, yj, atol=FIT_RTOL * np.abs(yj).max(),
                               rtol=0)
    jp = jbh.build_sparse_p(x, 15.0)
    monkeypatch.setattr(tbh, "build_sparse_p", lambda *a, **k: jp)
    bj = jbh.BarnesHutTsne(**kw).fit(x)
    bt = BarnesHutTsne(device="cpu", **kw).fit(x)
    np.testing.assert_allclose(bt, bj, atol=FIT_RTOL * np.abs(bj).max(),
                               rtol=0)


class TestLadderRepulsion:
    """``tests/test_barnes_hut.py::TestLadderRepulsion`` on the port."""

    @staticmethod
    def _exact(yn):
        d2 = ((yn[:, None, :] - yn[None, :, :]) ** 2).sum(-1)
        num = 1.0 / (1.0 + d2)
        np.fill_diagonal(num, 0.0)
        rep = ((num ** 2)[..., None]
               * (yn[:, None, :] - yn[None, :, :])).sum(1)
        return rep, num.sum(1)

    def test_matches_exact_forces(self):
        rs = np.random.RandomState(0)
        y = (rs.randn(800, 2) * 5).astype(np.float32)
        R, l0, L = tbh._ladder_config(800, 0.5)
        rep, z = tbh._bh_repulsion(torch.as_tensor(y), R=R, l0=l0, L=L)
        rep_ex, z_ex = self._exact(y.astype(np.float64))
        np.testing.assert_allclose(z.numpy(), z_ex, rtol=0.02)
        fmag = np.linalg.norm(rep_ex, axis=1).mean()
        err = np.linalg.norm(rep.numpy() - rep_ex, axis=1) / fmag
        assert err.mean() < 0.05, err.mean()

    def test_smaller_theta_is_more_accurate(self):
        rs = np.random.RandomState(1)
        y = (rs.randn(600, 2) * 3).astype(np.float32)
        rep_ex, _ = self._exact(y.astype(np.float64))

        def mean_err(theta):
            R, l0, L = tbh._ladder_config(600, theta)
            rep, _ = tbh._bh_repulsion(torch.as_tensor(y), R=R, l0=l0, L=L)
            fmag = np.linalg.norm(rep_ex, axis=1).mean()
            return (np.linalg.norm(rep.numpy() - rep_ex, axis=1)
                    / fmag).mean()

        assert mean_err(0.3) <= mean_err(1.0) + 1e-6


def test_bh_and_exact_separate_clusters():
    """``tests/test_barnes_hut.py::TestEndToEnd`` on the port."""
    def sep(y, n):
        ca, cb = y[:n].mean(0), y[n:].mean(0)
        intra = max(np.linalg.norm(y[:n] - ca, axis=1).mean(),
                    np.linalg.norm(y[n:] - cb, axis=1).mean())
        return np.linalg.norm(ca - cb) / intra

    x = two_clusters(n=100, d=6, seed=6, spread=0.4, gap=4.0)
    kw = dict(perplexity=12, max_iter=250, learning_rate=100.0, seed=0,
              device="cpu")
    bh = BarnesHutTsne(theta=0.5, **kw)
    y_bh = bh.fit(x)
    assert y_bh.shape == (200, 2) and np.isfinite(bh.kl)
    assert sep(y_bh, 100) > 2.0
    assert sep(Tsne(num_dimension=2, **kw).fit(x), 100) > 2.0
    with pytest.raises(ValueError, match="2 dimensions"):
        BarnesHutTsne(num_dimension=3, device="cpu")


def test_tsne_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (Tsne, BarnesHutTsne):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sparse_p(two_clusters(n=10), 3.0)
