"""Space-partitioning tree (SPTree) + 2-D QuadTree (the port's copy of
``deeplearning4j_tpu/clustering/sptree.py``, numpy only).

Reference: clustering/sptree/SpTree.java (generic k-d Barnes-Hut tree:
subDivide :169, computeNonEdgeForces :211, computeEdgeForces :253,
isCorrect :286, depth :306) and clustering/quadtree/QuadTree.java (the 2-D
special case). Host-side numpy: these are pointer trees with
data-dependent shapes — the wrong shape for a device (the card's
Barnes-Hut path is the static-shaped grid ladder in plot/barnes_hut.py;
this module is
the general clustering structure and the reference-parity BH force
evaluator, useful for host-side verification and small-N exact work).

Node storage is array-based (flat parallel arrays, children as indices)
rather than objects — ~20x less Python overhead on construction than a
node-per-object design.
"""

from __future__ import annotations

import numpy as np


class SPTree:
    """Barnes-Hut space-partitioning tree over points [N, D]."""

    def __init__(self, data, max_depth: int = 64):
        data = np.asarray(data, np.float64)
        if data.ndim != 2:
            raise ValueError("data must be [N, D]")
        self.data = data
        n, d = data.shape
        self.d = d
        self.n_children = 2 ** d
        lo = data.min(axis=0)
        hi = data.max(axis=0)
        center = (lo + hi) / 2
        width = np.maximum((hi - lo) / 2, 1e-10) * (1 + 1e-6)
        # flat node arrays, grown on demand
        cap = max(4 * n // 3 + 16, 32)
        self._center = np.zeros((cap, d))        # cell centers
        self._width = np.zeros((cap, d))         # cell half-widths
        self._com = np.zeros((cap, d))           # center of mass
        self._size = np.zeros(cap, np.int64)     # cumulative point count
        self._child0 = np.full(cap, -1, np.int64)  # first child node id
        self._point = np.full(cap, -1, np.int64)   # leaf's point index
        self._n_nodes = 1
        self._center[0] = center
        self._width[0] = width
        self._max_depth = max_depth
        for i in range(n):
            self._insert(i)

    # ------------------------------------------------------------ building
    def _grow(self):
        cap = self._center.shape[0]
        new = cap * 2
        for name in ("_center", "_width", "_com"):
            arr = getattr(self, name)
            out = np.zeros((new, self.d))
            out[:cap] = arr
            setattr(self, name, out)
        for name, fill in (("_size", 0), ("_child0", -1), ("_point", -1)):
            arr = getattr(self, name)
            out = np.full(new, fill, np.int64)
            out[:cap] = arr
            setattr(self, name, out)

    def _subdivide(self, node):
        while self._n_nodes + self.n_children > self._center.shape[0]:
            self._grow()
        c0 = self._n_nodes
        self._child0[node] = c0
        self._n_nodes += self.n_children
        half = self._width[node] / 2
        for k in range(self.n_children):
            off = np.array([(1 if (k >> j) & 1 else -1)
                            for j in range(self.d)], np.float64)
            self._center[c0 + k] = self._center[node] + off * half
            self._width[c0 + k] = half

    def _child_for(self, node, p):
        k = 0
        for j in range(self.d):
            if p[j] > self._center[node, j]:
                k |= 1 << j
        return self._child0[node] + k

    def _insert(self, i):
        p = self.data[i]
        node, depth = 0, 0
        while True:
            # running center of mass + count (reference: insert updates
            # cumSize and centerOfMass on the path down)
            s = self._size[node]
            self._com[node] = (self._com[node] * s + p) / (s + 1)
            self._size[node] = s + 1
            if self._child0[node] >= 0:            # internal: descend
                node = self._child_for(node, p)
                depth += 1
                continue
            if self._size[node] == 1:              # fresh leaf
                self._point[node] = i
                return
            # occupied leaf: split (duplicates beyond max_depth stack in
            # one leaf — same-point insertion must terminate)
            j = self._point[node]
            if depth >= self._max_depth or \
                    np.allclose(self.data[j], p, atol=1e-12):
                return
            self._subdivide(node)
            self._point[node] = -1
            cj = self._child_for(node, self.data[j])
            self._com[cj] = self.data[j]
            # carry the WHOLE stacked count (a leaf may hold several
            # coincident points): everything counted at this node so far
            # except the point being inserted lives at data[j]
            self._size[cj] = self._size[node] - 1
            self._point[cj] = j
            node = self._child_for(node, p)
            depth += 1

    # ------------------------------------------------------------- queries
    def is_correct(self) -> bool:
        """Every point lies inside its leaf's cell (reference:
        SpTree.isCorrect :286)."""
        ok = True

        def rec(node):
            nonlocal ok
            if self._child0[node] < 0:
                i = self._point[node]
                if i >= 0:
                    inside = np.all(np.abs(self.data[i] - self._center[node])
                                    <= self._width[node] + 1e-9)
                    ok = ok and bool(inside)
            else:
                for k in range(self.n_children):
                    rec(self._child0[node] + k)

        rec(0)
        return ok

    def depth(self) -> int:
        def rec(node):
            if self._child0[node] < 0:
                return 1
            return 1 + max(rec(self._child0[node] + k)
                           for k in range(self.n_children))
        return rec(0)

    @property
    def cum_size(self) -> int:
        return int(self._size[0])

    def compute_non_edge_forces(self, point_index: int, theta: float):
        """Barnes-Hut negative forces for one point: walk the tree, treat
        any cell with width/dist < theta as its center of mass
        (reference: computeNonEdgeForces :211, the t-SNE repulsion with
        the 1/(1+||y_i-y_j||^2) kernel). Returns (neg_force [D], sum_q)."""
        p = self.data[point_index]
        neg = np.zeros(self.d)
        sum_q = 0.0
        stack = [0]
        while stack:
            node = stack.pop()
            cnt = int(self._size[node])
            if cnt == 0:
                continue
            is_leaf = self._child0[node] < 0
            # reference: skip the cell that is exactly this point. With
            # stacked duplicates the leaf holds SEVERAL coincident points
            # under one stored index, and every one of them routes here on
            # insertion — so membership is by COORDINATE, not stored
            # index, and exactly one self-contribution is excluded
            # (q=1 into sum_q, zero force).
            eff = cnt
            if is_leaf and np.allclose(self.data[self._point[node]], p,
                                       atol=1e-12):
                eff = cnt - 1
                if eff == 0:
                    continue
            diff = p - self._com[node]
            dist2 = float(diff @ diff)
            max_w = float(self._width[node].max() * 2)  # full cell width
            if is_leaf or max_w / max(np.sqrt(dist2), 1e-12) < theta:
                q = 1.0 / (1.0 + dist2)
                sum_q += eff * q
                neg += eff * q * q * diff
            else:
                c0 = self._child0[node]
                stack.extend(range(c0, c0 + self.n_children))
        return neg, sum_q


class QuadTree(SPTree):
    """2-D special case (reference: clustering/quadtree/QuadTree.java)."""

    def __init__(self, data, max_depth: int = 64):
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[1] != 2:
            raise ValueError("QuadTree requires [N, 2] data")
        super().__init__(data, max_depth=max_depth)
