"""Barnes-Hut t-SNE (the port of ``deeplearning4j_tpu/plot/barnes_hut.py``;
reference: plot/BarnesHutTsne.java:65 + the SPTree in
clustering/sptree/SpTree.java).

The reference walks a pointer-based quadtree per point per iteration
(SpTree.computeNonEdgeForces) — adaptive, sequential, unvectorizable. As in
the JAX package, the SAME far-field approximation (a distant cell of points
acts through its centroid, opening criterion s/d < theta) is expressed as a
fixed MULTIRESOLUTION GRID LADDER with FMM-style interaction lists:

- levels l0..L of 2^l x 2^l grids over the embedding bbox; per level, cell
  counts and centroid sums are one ``index_add_``;
- a point interacts with the cells of level l that lie in the refinement
  ring of its parent cell's near region (children of the parent's
  (2R+1)^2 neighborhood minus its own (2R+1)^2 neighborhood, R = ceil(1/theta)
  — exactly the cells whose size/distance ratio first satisfies the opening
  criterion at this level);
- at the finest level the near region is taken at cell granularity, with L
  chosen so cells hold ~1 point (the centroid of a 1-point cell IS the
  point, so the near field is near-exact).

Every cell of the finest partition is counted exactly once across the
ladder. All shapes are static: the step is gathers, ``index_add_`` and
elementwise math on the card. On CUDA ``index_add_`` sums through atomics,
so two runs agree to rounding, not bit for bit.

The attractive (kNN) term uses the standard sparse symmetrized-P edge list
(reference computeGaussianPerplexity with its VPTree kNN; here kNN is a
chunked matmul + top-k on the card, and the perplexity search the JAX
package's host arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch import resolve_device


# ------------------------------------------------------------------ kNN + P
def _knn(x, k: int, chunk: int = 1024, device=None):
    """k nearest neighbors by chunked matmul + top-k on ``device``.
    Returns (idx [N,k], d2 [N,k]) excluding self."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    n = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    idxs, d2s = [], []
    with torch.inference_mode():
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            d2 = sq[s:e, None] - 2.0 * (x[s:e] @ x.T) + sq[None, :]
            vals, idx = torch.topk(d2, k + 1, dim=1, largest=False)
            idxs.append(idx.cpu().numpy())
            d2s.append(vals.cpu().numpy())
    idx = np.concatenate(idxs)
    d2 = np.concatenate(d2s)
    # drop self (it is the 0-distance hit; fall back to dropping the last
    # column for rows where numerical noise hid it)
    rows = np.arange(n)[:, None]
    degenerate = ~np.any(idx == rows, axis=1)
    self_pos = np.argmax(idx == rows, axis=1)
    # degenerate rows (duplicates/ties hid the self-hit): drop the FARTHEST
    # candidate, keeping the true nearest neighbor in column 0
    self_pos[degenerate] = idx.shape[1] - 1
    keep = np.ones_like(idx, bool)
    keep[np.arange(n), self_pos] = False
    idx = idx[keep].reshape(n, k)
    d2 = np.maximum(d2[keep].reshape(n, k), 0.0)
    return idx, d2


def _perplexity_search(d2: np.ndarray, perplexity: float, tol=1e-5,
                      max_tries=50) -> np.ndarray:
    """Vectorized per-row precision search on the kNN distances (same
    bisection as BarnesHutTsne.computeGaussianPerplexity, all rows at
    once). Returns conditional probabilities [N, k]."""
    n = d2.shape[0]
    target = np.log(perplexity)
    beta = np.ones(n)
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    p = np.zeros_like(d2)
    for _ in range(max_tries):
        p = np.exp(-d2 * beta[:, None])
        sum_p = np.maximum(p.sum(axis=1), 1e-12)
        h = np.log(sum_p) + beta * (d2 * p).sum(axis=1) / sum_p
        diff = h - target
        done = np.abs(diff) < tol
        if done.all():
            break
        too_high = diff > 0
        lo = np.where(too_high & ~done, beta, lo)
        hi = np.where(~too_high & ~done, beta, hi)
        beta = np.where(
            too_high & ~done,
            np.where(np.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            np.where(~done,
                     np.where(np.isneginf(lo), beta / 2.0, (beta + lo) / 2.0),
                     beta))
    return p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)


def build_sparse_p(x, perplexity: float, k: int | None = None, *,
                   device=None):
    """Symmetrized sparse input similarities as a COO edge list
    (edges_i, edges_j, edges_p), each [2*N*k]. Sum of edges_p == 1. The
    kNN runs on ``device`` (CUDA unless the caller passes another)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if k is None:
        k = min(n - 1, int(3 * perplexity))
    idx, d2 = _knn(x, k, device=device)
    cond_p = _perplexity_search(d2, min(perplexity, (n - 1) / 3.0))
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    cols = idx.astype(np.int32).ravel()
    vals = cond_p.ravel()
    # symmetrize: P = (P + P^T) / 2N over the union graph == concatenating
    # each directed edge and its reverse at half weight
    ei = np.concatenate([rows, cols])
    ej = np.concatenate([cols, rows])
    ep = np.concatenate([vals, vals]) / (2.0 * n)
    ep = ep / max(ep.sum(), 1e-12)
    return ei, ej, ep


# -------------------------------------------------------------- BH ladder
def _ladder_config(n: int, theta: float):
    """Static level plan. R = ceil(1/theta) cells is the near radius the
    opening criterion s/d < theta demands; L makes finest cells ~1 point."""
    R = int(min(4, max(1, np.ceil(1.0 / max(theta, 0.25)))))
    l0 = int(np.ceil(np.log2(2 * R + 2)))          # coarsest useful grid
    L = max(l0, int(np.ceil(np.log(max(n, 4)) / np.log(4))) + 1)
    return R, l0, L


def _bh_repulsion(y, *, R: int, l0: int, L: int):
    """Repulsive numerator forces and partition Z via the grid ladder.
    y: [N, 2]. Returns (rep [N,2] = sum n_c k^2 (y - mu_c), z [N])."""
    n = y.shape[0]
    dev = y.device
    lo = torch.min(y, dim=0).values
    span = torch.clamp(torch.max(torch.max(y, dim=0).values - lo), min=1e-9)
    y01 = (y - lo) / span * (1.0 - 1e-6)

    rep = torch.zeros_like(y)
    z = torch.zeros((n,), dtype=y.dtype, device=dev)
    ones = torch.ones((n,), dtype=y.dtype, device=dev)

    def cell_tables(level):
        G = 1 << level
        ci = torch.clamp((y01 * G).to(torch.int64), 0, G - 1)   # [N, 2]
        flat = ci[:, 0] * G + ci[:, 1]
        cnt = torch.zeros((G * G,), dtype=y.dtype,
                          device=dev).index_add_(0, flat, ones)
        sums = torch.zeros((G * G, 2), dtype=y.dtype,
                           device=dev).index_add_(0, flat, y)
        return G, ci, cnt, sums

    def interact(cnt, sums, G, cells):
        """cells: [N, M, 2] int64 candidate cells (may be masked with -1)."""
        valid = ((cells[..., 0] >= 0) & (cells[..., 0] < G)
                 & (cells[..., 1] >= 0) & (cells[..., 1] < G))
        flat = torch.clamp(cells[..., 0] * G + cells[..., 1], 0, G * G - 1)
        n_c = torch.where(valid, cnt[flat], 0.0)                  # [N, M]
        mu = sums[flat] / torch.clamp(n_c, min=1.0)[..., None]    # [N, M, 2]
        diff = y[:, None, :] - mu
        kq = 1.0 / (1.0 + torch.sum(diff * diff, dim=-1))         # [N, M]
        kq = torch.where(n_c > 0, kq, 0.0)
        return (torch.sum((n_c * kq * kq)[..., None] * diff, dim=1),
                torch.sum(n_c * kq, dim=1))

    def grid(lo_, hi_):
        r = torch.arange(lo_, hi_, device=dev)
        gx, gy = torch.meshgrid(r, r, indexing="ij")
        return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)

    # refinement block edge: the parent's near region is (2R+1) cells per
    # dim, whose children span 2*(2R+1) cells starting at 2*(parent - R)
    side = 2 * (2 * R + 1)
    for level in range(l0, L + 1):
        G, ci, cnt, sums = cell_tables(level)
        if level == l0:
            # all cells of the coarsest grid beyond the near region
            cells = grid(0, G)[None].expand(n, G * G, 2)
        else:
            # children of the parent's near region, minus own near region
            base = 2 * ((ci >> 1) - R)                            # [N, 2]
            cells = base[:, None, :] + grid(0, side)[None, :, :]  # [N, s^2, 2]
        near = (torch.max(torch.abs(cells - ci[:, None, :]), dim=-1).values
                <= R)
        cells = torch.where(near[..., None], -1, cells)
        r_l, z_l = interact(cnt, sums, G, cells)
        rep = rep + r_l
        z = z + z_l
        if level == L:
            # near region at the finest level, at cell granularity (cells
            # hold ~1 point); subtract the self pair (num_ii = 1, force 0)
            cells = ci[:, None, :] + grid(-R, R + 1)[None, :, :]
            r_l, z_l = interact(cnt, sums, G, cells)
            rep = rep + r_l
            z = z + z_l - 1.0
    return rep, z


def make_bh_step(n: int, theta: float):
    """Build the BH gradient step for a fixed N/theta."""
    R, l0, L = _ladder_config(n, theta)

    def step(y, gains, inc, ei, ej, ep, momentum: float, lr: float):
        yi = y[ei]
        yj = y[ej]
        diff = yi - yj
        num = 1.0 / (1.0 + torch.sum(diff * diff, dim=-1))
        attr = torch.zeros_like(y).index_add_(
            0, ei, (ep * num)[:, None] * diff)                    # [N, 2]
        rep, z = _bh_repulsion(y, R=R, l0=l0, L=L)
        zsum = torch.clamp(torch.sum(z), min=1e-12)
        grad = 4.0 * (attr - rep / zsum)
        gains = torch.where(torch.sign(grad) != torch.sign(inc),
                            gains + 0.2, gains * 0.8)
        gains = torch.clamp(gains, min=0.01)
        inc = momentum * inc - lr * gains * grad
        y = y + inc
        y = y - torch.mean(y, dim=0)
        # sparse-P KL estimate (reference reports the same edge sum)
        q = torch.clamp(num / zsum, min=1e-12)
        kl = torch.sum(ep * torch.log(torch.clamp(ep, min=1e-12) / q))
        return y, gains, inc, kl

    return step


class BarnesHutTsne:
    """reference: plot/BarnesHutTsne.java:65 — same knobs/surface as Tsne,
    with the grid-ladder BH gradient (theta honored) and sparse kNN input
    similarities, so reference-scale N (~100k words) embeds in minutes."""

    def __init__(self, num_dimension: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 max_iter: int = 500, momentum: float = 0.5,
                 final_momentum: float = 0.8, switch_momentum_iter: int = 250,
                 stop_lying_iter: int = 100, exaggeration: float = 12.0,
                 seed: int = 42, device=None):
        self.device = resolve_device(device)
        if num_dimension != 2:
            raise ValueError("BarnesHutTsne embeds to 2 dimensions (the "
                             "reference's quadtree is 2-D too); use Tsne "
                             "for other target dims")
        self.num_dimension = num_dimension
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iter = switch_momentum_iter
        self.stop_lying_iter = stop_lying_iter
        self.exaggeration = exaggeration
        self.seed = seed
        self.y: np.ndarray = None
        self.kl: float = float("nan")

    def fit(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        dev = self.device
        ei, ej, ep = build_sparse_p(x, self.perplexity, device=dev)
        ei = torch.as_tensor(ei, dtype=torch.int64, device=dev)
        ej = torch.as_tensor(ej, dtype=torch.int64, device=dev)
        ep_plain = torch.as_tensor(ep, dtype=torch.float32, device=dev)
        ep_lying = ep_plain * self.exaggeration
        step = make_bh_step(n, self.theta)

        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(rng.normal(0, 1e-4, (n, 2)),
                            dtype=torch.float32, device=dev)
        gains = torch.ones_like(y)
        inc = torch.zeros_like(y)
        kl = torch.tensor(float("inf"))
        with torch.inference_mode():
            for it in range(self.max_iter):
                mom = self.momentum if it < self.switch_momentum_iter \
                    else self.final_momentum
                p_cur = ep_lying if it < self.stop_lying_iter else ep_plain
                y, gains, inc, kl = step(y, gains, inc, ei, ej, p_cur,
                                         float(np.float32(mom)),
                                         float(np.float32(
                                             self.learning_rate)))
        self.y = y.cpu().numpy()
        self.kl = float(kl)
        return self.y

    def get_y(self) -> np.ndarray:
        return self.y
