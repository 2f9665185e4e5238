"""HNSW graph index: the VPTree lineage's navigable-small-world form (the
port's copy of ``deeplearning4j_tpu/nearestneighbors/hnsw.py``, numpy only,
so a graph built from the same points is bitwise the JAX package's).

The reference retrieval stack ships a host VPTree
(``clustering/vptree/``) — a metric tree whose query walk is
inherently sequential and pointer-chasing, which is exactly why
brute.py inverted it into one device matmul. HNSW is the modern
incarnation of the same host-side idea: a layered proximity graph
(Malkov & Yashunin) where a query greedily descends geometric levels
to a good entry point, then runs an ef-bounded best-first beam on the
bottom layer. Search cost is O(ef · m · log N) distance rows instead
of O(N), so at the 10M+ point where even an IVF probe's candidate
gather is heavy, the graph walk answers from a few thousand rows.

This implementation is deliberately plain numpy — deterministic
(seeded geometric level draws, stable neighbor selection) so an index
rebuilt from the same points answers bit-identically, host-resident
(it composes with the int8/mesh *device* stores as an alternative, not
a layer), and served behind ``EmbeddingIndex``'s identical
``submit()``/coalescer surface with ``knn_recall`` as the
first-class acceptance gauge.

Distances: euclidean, or cosine on pre-normalized rows (the caller —
``EmbeddingIndex._build_store`` — normalizes once at build, exactly as
the flat/IVF stores do).
"""

from __future__ import annotations

import numpy as np

__all__ = ["HNSWGraph"]


class HNSWGraph:
    """Deterministic numpy HNSW over [N, D] f32 vectors.

    ``m`` is the per-node degree target (layer 0 keeps ``2m``);
    ``ef_construction`` bounds the insert-time beam. ``search_batch``
    mirrors the device kernels' contract: (distances [Q, k],
    indices [Q, k]) nearest-first, distances euclidean (sqrt'd) or
    cosine, padded with +inf/-1 when the graph holds fewer than k
    points."""

    def __init__(self, vectors, *, metric: str = "euclidean", m: int = 16,
                 ef_construction: int = 64, seed: int = 0):
        if metric not in ("euclidean", "cosine"):
            raise ValueError(f"metric must be euclidean|cosine, got {metric}")
        if int(m) < 2:
            raise ValueError(f"m must be >= 2, got {m}")
        self.vectors = np.ascontiguousarray(vectors, np.float32)
        if self.vectors.ndim != 2 or self.vectors.shape[0] < 1:
            raise ValueError("vectors must be a non-empty [N, D] array")
        self.metric = metric
        self.m = int(m)
        self.m0 = 2 * self.m
        self.ef_construction = max(int(ef_construction), self.m)
        n = self.vectors.shape[0]
        rng = np.random.RandomState(seed)
        # geometric level draws, all up front — insertion order plus
        # these levels fully determine the graph
        ml = 1.0 / np.log(self.m)
        u = rng.random_sample(n)
        self._node_level = np.minimum(
            (-np.log(np.maximum(u, 1e-12)) * ml).astype(np.int64), 31)
        self.levels = int(self._node_level.max()) + 1
        # adjacency per level: [n, cap] int32, -1 padded
        self._nbr = [np.full((n, self.m0 if lv == 0 else self.m), -1,
                             np.int32) for lv in range(self.levels)]
        self._nbr_cnt = [np.zeros(n, np.int32) for _ in range(self.levels)]
        self._entry = 0
        self._entry_level = int(self._node_level[0])
        for i in range(1, n):
            self._insert(i)

    @property
    def nbytes(self) -> int:
        return int(self.vectors.nbytes
                   + sum(a.nbytes for a in self._nbr)
                   + sum(a.nbytes for a in self._nbr_cnt))

    # ------------------------------------------------------------ distance
    def _dist_rows(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Squared-euclidean (or cosine) distance of one query to a
        candidate row set — the single vectorized primitive every walk
        step reduces to."""
        v = self.vectors[rows]
        if self.metric == "cosine":
            return np.maximum(1.0 - v @ q, 0.0)
        diff = v - q[None, :]
        return np.einsum("nd,nd->n", diff, diff)

    # ------------------------------------------------------------- insert
    def _greedy_step(self, q: np.ndarray, ep: int, lv: int) -> int:
        """Greedy descent on one level: hop to the nearest neighbor
        until no neighbor improves."""
        cur = ep
        cur_d = float(self._dist_rows(q, np.array([cur]))[0])
        while True:
            cnt = self._nbr_cnt[lv][cur]
            if cnt == 0:
                return cur
            rows = self._nbr[lv][cur, :cnt]
            d = self._dist_rows(q, rows)
            j = int(np.argmin(d))
            if d[j] >= cur_d:
                return cur
            cur = int(rows[j])
            cur_d = float(d[j])

    def _beam(self, q: np.ndarray, ep: int, ef: int, lv: int):
        """Best-first beam of width ``ef`` on one level; returns
        (ids, dists) sorted nearest-first."""
        visited = {ep}
        d0 = float(self._dist_rows(q, np.array([ep]))[0])
        cand = [(d0, ep)]           # frontier, nearest popped first
        best = [(d0, ep)]           # result beam, kept sorted
        while cand:
            j = min(range(len(cand)), key=lambda i: cand[i][0])
            cd, cid = cand.pop(j)
            if cd > best[-1][0] and len(best) >= ef:
                break
            cnt = self._nbr_cnt[lv][cid]
            if cnt == 0:
                continue
            rows = self._nbr[lv][cid, :cnt]
            fresh = np.array([r for r in rows if int(r) not in visited],
                             np.int64)
            if fresh.size == 0:
                continue
            visited.update(int(r) for r in fresh)
            d = self._dist_rows(q, fresh)
            bound = best[-1][0]
            for dd, rr in zip(d, fresh):
                dd = float(dd)
                if len(best) < ef or dd < bound:
                    cand.append((dd, int(rr)))
                    best.append((dd, int(rr)))
                    best.sort()
                    if len(best) > ef:
                        best.pop()
                    bound = best[-1][0]
        ids = np.array([b[1] for b in best], np.int64)
        return ids, np.array([b[0] for b in best], np.float32)

    def _link(self, lv: int, a: int, b: int) -> None:
        """Add edge a->b, evicting a's farthest neighbor at capacity
        (stable: ties keep the earlier edge)."""
        cap = self._nbr[lv].shape[1]
        cnt = int(self._nbr_cnt[lv][a])
        if cnt < cap:
            self._nbr[lv][a, cnt] = b
            self._nbr_cnt[lv][a] = cnt + 1
            return
        rows = np.concatenate([self._nbr[lv][a, :cnt], [b]]).astype(np.int64)
        d = self._dist_rows(self.vectors[a], rows)
        keep = np.argsort(d, kind="stable")[:cap]
        self._nbr[lv][a, :cap] = rows[keep]

    def _insert(self, i: int) -> None:
        q = self.vectors[i]
        lv_i = int(self._node_level[i])
        ep = self._entry
        for lv in range(self._entry_level, lv_i, -1):
            ep = self._greedy_step(q, ep, lv)
        for lv in range(min(lv_i, self._entry_level), -1, -1):
            ids, _d = self._beam(q, ep, self.ef_construction, lv)
            take = ids[:self.m0 if lv == 0 else self.m]
            for t in take:
                t = int(t)
                self._link(lv, i, t)
                self._link(lv, t, i)
            ep = int(ids[0])
        if lv_i > self._entry_level:
            self._entry = i
            self._entry_level = lv_i

    # ------------------------------------------------------------- search
    def search(self, query, k: int, *, ef: int = 64):
        """(distances [k], indices [k]) nearest-first for one query."""
        q = np.asarray(query, np.float32).ravel()
        if self.metric == "cosine":
            q = q / max(float(np.linalg.norm(q)), 1e-12)
        ep = self._entry
        for lv in range(self._entry_level, 0, -1):
            ep = self._greedy_step(q, ep, lv)
        ids, d = self._beam(q, ep, max(int(ef), k), 0)
        ids, d = ids[:k], d[:k]
        if self.metric != "cosine":
            d = np.sqrt(d)
        if ids.size < k:
            pad = k - ids.size
            ids = np.concatenate([ids, np.full(pad, -1, np.int64)])
            d = np.concatenate([d, np.full(pad, np.inf, np.float32)])
        return d.astype(np.float32), ids.astype(np.int32)

    def search_batch(self, queries, k: int, *, ef: int = 64):
        """(distances [Q, k], indices [Q, k]) — the device kernels'
        exact return contract, so ``EmbeddingIndex``'s completer slices
        it untouched."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        d = np.empty((q.shape[0], k), np.float32)
        idx = np.empty((q.shape[0], k), np.int32)
        for r in range(q.shape[0]):
            d[r], idx[r] = self.search(q[r], k, ef=ef)
        return d, idx
