"""EmbeddingIndex: device-resident vector store + coalesced k-NN serving (the
port of ``deeplearning4j_tpu/nearestneighbors/index.py``).

The reference retrieval stack is a host VPTree behind a Play REST server
(deeplearning4j-nearestneighbor-server). The accelerator inversion
(brute.py) computes ALL distances as one [Q, N] matmul + top-k — this
module grows that search into a serving subsystem:

* **Encode**: documents batch-encode through any encoder exposing
  ``output(x)`` (``ParallelInference`` over a net, a zoo model) or a plain
  callable, straight into the store.
* **Store**: device-resident, f32 or absmax per-ROW int8
  (optimize/quantize.py's recipe with the row as the "channel"); the
  query product is ``(q @ P_q.T) * scale``. The JAX package's XLA fuses
  the int8 → f32 widening into that matmul; ``torch.matmul`` takes f32
  operands, so each dispatch widens the int8 rows into an f32 transient
  of the store's size (``resident_bytes`` counts only the resident int8
  arrays, as JAX's does).
* **IVF**: a partitioned variant for the 10M+-vector regime — k-means
  centroids (clustering/), an nprobe-limited candidate gather, and an
  exact re-rank of the gathered candidates.
* **HNSW**: ``store="hnsw"`` swaps in a host-resident graph index
  (hnsw.py, bitwise the JAX package's graph) behind the identical
  ``submit()``/coalescer surface with recall as a first-class gauge.
* **Serve**: ``submit() -> Future`` queries flow through a background
  coalescer (``ServingLoop`` inbox mode) as ParallelInference's do: N
  one-row submits become ONE matmul+top-k dispatch, bucketed pow2 on both
  the query rows and k. The coalescer thread launches the search and
  records a CUDA event; the completer waits on the event and copies the
  rows to the host, while the coalescer assembles the next batch. The
  serving posture rides along: Deadline/RetryPolicy/CircuitBreaker/
  AdmissionController, supervised loops, MetricsRegistry counters and the
  ``knn_latency_ms`` histogram, and the ReplicaFleet duck type
  (submit/drain/close/stats, ``active_slot_cap``/``set_active_slots``).

The exact f32 path calls brute.py's ``_knn`` with the identical upload and
pad/bucket arithmetic, so on one device it is bitwise
``DeviceBruteForceIndex`` by construction. The int8 store and the IVF lists
are built by deterministic host arithmetic (the JAX package's, so the codes
and scales are bitwise its), so a drained/restarted index rebuilt from the
same points answers bitwise as before on the same card.

Mesh-sharded stores (``mesh=``, a ``parallel.mesh.Mesh`` with a ``data``
axis) split the rows over the data entries, each entry's arrays on its own
device (JAX's ``_knn_aux``/``_knn_int8`` under a points-axis sharding and
its probe-local IVF). Every entry scores its own ``[Q, N/m]`` block (or
probes its own C/m cells) and keeps a local top-kb with squared distances;
ONE merge of the ``[Q, m*kb]`` candidates runs on the consumer's device
(the first data entry), breaking distance ties by the lower global row id
as ``lax.top_k`` does on the unsharded store, then applies the sqrt.
``kmeans="sharded"`` trains the IVF centroids with per-entry assignment,
partial sums and counts, and the written-out ``parallel.mesh.psum``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.nearestneighbors.brute import (_check_k, _knn,
                                                          _pad_queries, _pow2,
                                                          _upload)
from deeplearning4j_torch.optimize.bucketing import BoundedCache
from deeplearning4j_torch.parallel.mesh import data_devices, psum
from deeplearning4j_torch.parallel.resilience import (AdmissionController,
                                                      ChaosPolicy,
                                                      CircuitBreaker,
                                                      CircuitOpen, Deadline,
                                                      DeadlineExceeded,
                                                      RetryPolicy)
from deeplearning4j_torch.parallel.runtime import (LoopClosed, LoopCrashed,
                                                   ServingLoop, supervisor)


# --------------------------------------------------------------------------
# device searches
# --------------------------------------------------------------------------
# Every search returns (distances [Q, k], indices [Q, k] int32)
# nearest-first. ``aux`` carries ||p||^2 of the stored rows for euclidean
# (+inf on empty IVF slots, so one can never be selected) and a 0/+inf bias
# for cosine, added after the 1 - q.p term.

def _knn_int8(qpoints, scales, aux, queries, *, k: int, metric: str):
    """int8 store: absmax per-row quantized points, ``(q @ P_q.T) * scale``
    (``_knn_int8_local`` on the whole store, then the sqrt)."""
    d, idx = _knn_int8_local(qpoints, scales, aux, queries, k=k,
                             metric=metric)
    if metric != "cosine":
        d = torch.sqrt(d)
    return d, idx.to(torch.int32)


def _ivf_query(queries, metric: str):
    """(q, ||q||^2) as the IVF probe reads them: cosine queries normalized
    with unit norms."""
    if metric == "cosine":
        q = queries / torch.clamp(torch.linalg.norm(queries, dim=1,
                                                    keepdim=True), min=1e-12)
        return q, torch.ones((q.shape[0], 1), dtype=q.dtype,
                             device=q.device)
    return queries, torch.sum(queries * queries, dim=1, keepdim=True)


def _knn_ivf(centroids, cbias, vecs, scales, laux, ids, queries, *,
             k: int, nprobe: int, metric: str):
    """IVF query: score the [Q, C] centroid distances, gather the
    ``nprobe`` nearest lists' vectors, exact re-rank the gathered
    candidates, and map the local top-k back to global ids
    (``_probe_local_rank`` over every cell, then the sqrt). ``scales=None``
    is the f32-list store; an int8 store passes the [C, M] per-row scales
    and the dequant scales the candidate products as in ``_knn_int8``.

    Probe selection is always euclidean-on-the-stored-rows: cosine stores
    arrive pre-normalized, where euclidean order == cosine order."""
    q, qn = _ivf_query(queries, metric)
    d, idx = _probe_local_rank(centroids, cbias, vecs, scales, laux, ids, q,
                               qn, k=k, nprobe=nprobe, metric=metric)
    if metric != "cosine":
        d = torch.sqrt(d)
    return d, idx


def _assign_chunk(x, centroids):
    """Nearest-centroid assignment for one build chunk (on the card, so
    the 1M+-row assignment sweep is a handful of matmuls)."""
    xn = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=1)
    d2 = xn - 2.0 * (x @ centroids.T) + c2[None, :]
    return torch.argmin(d2, dim=1)


def _knn_aux(points, aux, queries, *, k: int, metric: str):
    """One entry's block of a sharded f32 store: (squared-for-euclidean
    distances [Q, k], local row indices [Q, k]). ``aux`` is ||p||^2 for
    euclidean and 0 for cosine, +inf on the pad rows, so a pad row is
    never chosen while a real one is left."""
    if metric == "cosine":
        q = queries / torch.clamp(torch.linalg.norm(queries, dim=1,
                                                    keepdim=True), min=1e-12)
        dists = (q @ points.T).neg_().add_(1.0).clamp_(min=0.0)
        dists = dists.add_(aux[None, :])
    else:
        qn = torch.sum(queries * queries, dim=1, keepdim=True)
        dists = (queries @ points.T).mul_(-2.0).add_(qn)
        dists = dists.add_(aux[None, :]).clamp_(min=0.0)
    return torch.topk(dists, k, dim=1, largest=False, sorted=True)


def _knn_int8_local(qpoints, scales, aux, queries, *, k: int, metric: str):
    """(squared-for-euclidean distances, indices) of the top k over int8
    rows: ``(q @ P_q.T) * scale``, dequantized on the fly. For euclidean
    ``aux`` carries the DEQUANTIZED rows' ||p||^2, so the distances are
    exact distances to the reconstructed vectors. The whole store's
    search (``_knn_int8``) and one entry's block of a sharded store."""
    wide = qpoints.to(queries.dtype)
    if metric == "cosine":
        q = queries / torch.clamp(torch.linalg.norm(queries, dim=1,
                                                    keepdim=True), min=1e-12)
        dots = (q @ wide.T).mul_(scales[None, :])
        dists = dots.neg_().add_(1.0).clamp_(min=0.0).add_(aux[None, :])
    else:
        qn = torch.sum(queries * queries, dim=1, keepdim=True)
        dots = (queries @ wide.T).mul_(scales[None, :])
        dists = dots.mul_(-2.0).add_(qn).add_(aux[None, :]).clamp_(min=0.0)
    del wide
    return torch.topk(dists, k, dim=1, largest=False, sorted=True)


def _probe_local_rank(centroids, cbias, vecs, scales, laux, ids, q, qn, *,
                      k: int, nprobe: int, metric: str):
    """One entry's probe-local IVF search (JAX's shard_map body): probe
    the ``min(nprobe, local cells)`` nearest LOCAL cells, gather their
    vectors locally, re-rank to the local top-k, and pad to k with
    +inf/-1 so the one merge over the [Q, entries*k] concatenation is
    exact. Distances stay squared for euclidean (the merge applies the
    sqrt). Any cell in the global top-``nprobe`` is in its home entry's
    local top-``nprobe``, so the union pool is a superset of the global
    probe's."""
    Qn = q.shape[0]
    p = min(nprobe, centroids.shape[0])
    c2 = torch.sum(centroids * centroids, dim=1)
    cd = qn - 2.0 * (q @ centroids.T) + c2[None, :] + cbias[None, :]
    probes = torch.topk(cd, p, dim=1, largest=False, sorted=True).indices
    aux = laux[probes].reshape(Qn, -1)
    gids = ids[probes].reshape(Qn, -1)
    M = aux.shape[1]
    flat = vecs[probes].reshape(Qn, M, -1).to(q.dtype)
    dots = torch.bmm(flat, q[:, :, None])[:, :, 0]
    del flat
    if scales is not None:
        dots = dots.mul_(scales[probes].reshape(Qn, M))
    if metric == "cosine":
        dists = dots.neg_().add_(1.0).clamp_(min=0.0).add_(aux)
    else:
        dists = dots.mul_(-2.0).add_(qn).add_(aux).clamp_(min=0.0)
    kk = min(k, M)
    d, loc = torch.topk(dists, kk, dim=1, largest=False, sorted=True)
    lids = torch.gather(gids, 1, loc)
    if kk < k:
        d = torch.cat([d, d.new_full((Qn, k - kk), float("inf"))], dim=1)
        lids = torch.cat([lids, lids.new_full((Qn, k - kk), -1)], dim=1)
    return d, lids


def _merge_candidates(dists, ids, device, *, k: int, metric: str):
    """The one merge of the entries' candidates on ``device``: the [Q,
    entries*kb] concatenation in mesh order, ordered by (distance, global
    id) with two stable sorts, so ties go to the lower row id whatever
    order each entry's top-k left them in. Returns (distances, int32
    ids), the sqrt applied for euclidean."""
    d = torch.cat([t.to(device) for t in dists], dim=1)
    i = torch.cat([t.to(device, torch.int64) for t in ids], dim=1)
    i, by_id = torch.sort(i, dim=1, stable=True)
    d = torch.gather(d, 1, by_id)
    d, by_d = torch.sort(d, dim=1, stable=True)
    d = d[:, :k]
    i = torch.gather(i, 1, by_d[:, :k])
    if metric != "cosine":
        d = torch.sqrt(d)
    return d, i.to(torch.int32)


def _kmeans_step(xs, cs):
    """One sharded Lloyd iteration over the data entries: per-entry
    nearest-centroid assignment and per-entry partial sums and counts
    (a one-hot product, as JAX's ``_kmeans_step``), summed over the
    entries in mesh order by ``psum``. Empty clusters keep their
    centroid. Returns (new centroids per entry, max shift as a tensor)."""
    sums, cnts = [], []
    for x, c in zip(xs, cs):
        xn = torch.sum(x * x, dim=1, keepdim=True)
        c2 = torch.sum(c * c, dim=1)
        d2 = xn - 2.0 * (x @ c.T) + c2[None, :]
        oh = torch.nn.functional.one_hot(torch.argmin(d2, dim=1),
                                         c.shape[0]).to(x.dtype)
        sums.append(oh.T @ x)
        cnts.append(torch.sum(oh, dim=0))
    sums, cnts = psum(sums), psum(cnts)
    new = [torch.where(n[:, None] > 0.5, s / torch.clamp(n, min=1.0)[:, None],
                       c) for s, n, c in zip(sums, cnts, cs)]
    return new, torch.max(torch.abs(new[0] - cs[0]))


# --------------------------------------------------------------------------
# store construction (host-side, deterministic)
# --------------------------------------------------------------------------

def _quantize_rows(pts: np.ndarray):
    """Absmax per-ROW int8 (quantize_array's recipe with the row as the
    channel — each stored vector gets its own scale, so one outlier
    vector cannot crush every other row's resolution). Deterministic
    host arithmetic, the JAX package's: rebuilding from the same points is
    bitwise, and the codes and scales are bitwise JAX's."""
    absmax = np.max(np.abs(pts), axis=1)
    scale = (absmax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(pts / safe[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


class _Store:
    """One immutable device-store snapshot. ``add()`` builds a fresh
    snapshot and swaps the reference atomically, so the serving loops
    read a coherent store lock-free (EmbeddingIndex._LOOP_OWNED)."""

    __slots__ = ("variant", "n", "dim", "arrays", "nprobe", "n_lists",
                 "list_len", "spilled", "resident_bytes", "graph",
                 "shards", "offsets")

    def __init__(self, variant, n, dim, arrays, nprobe=0, n_lists=0,
                 list_len=0, spilled=0, graph=None, shards=None,
                 offsets=None):
        self.variant = variant      # exact | aux | int8 | ivf | hnsw
        self.n = n
        self.dim = dim
        self.arrays = arrays
        self.nprobe = nprobe
        self.n_lists = n_lists
        self.list_len = list_len
        self.spilled = spilled
        self.graph = graph          # HNSWGraph (store="hnsw")
        # a mesh store: one tuple of arrays per data entry, and each
        # flat entry's first global row (IVF lists carry global ids)
        self.shards = shards
        self.offsets = offsets
        if shards is not None:
            arrays = tuple(a for sh in shards for a in sh)
        self.resident_bytes = sum(_nbytes(a) for a in arrays
                                  if a is not None)
        if graph is not None:
            self.resident_bytes += graph.nbytes


class _QueryRequest:
    """One submitted query batch: rows + the future its slice lands in,
    the k it asked for and the pow2 bucket kb it dispatches under (the
    coalesce signature, so only same-program requests merge)."""

    __slots__ = ("q", "k", "kb", "n", "future", "deadline", "t0")

    def __init__(self, q, k, kb, deadline: Optional[Deadline] = None):
        self.q = q
        self.k = k
        self.kb = kb
        self.n = q.shape[0]
        self.future: Future = Future()
        self.deadline = deadline
        self.t0 = time.monotonic()

    def signature(self):
        return (self.q.shape[1], self.kb)


def _shard_bytes(st: "_Store") -> list:
    """Device bytes of each entry of a mesh store."""
    return [sum(_nbytes(a) for a in sh if a is not None)
            for sh in st.shards]


class EmbeddingIndex:
    """Device-resident vector store with a coalescing query server.

    >>> index = EmbeddingIndex(points, store="int8")
    >>> d, i = index.search_batch_arrays(queries, k=5)     # sync
    >>> fut = index.submit(query_row, k=5)                 # coalesced
    >>> d, i = fut.result()

    ``store="f32"`` (default) is bitwise ``DeviceBruteForceIndex`` on the
    same device; ``store="int8"`` trades exactness for ~3.3x capacity at
    D=32. ``partitions=C`` builds the IVF variant (k-means centroids,
    ``nprobe`` probed lists per query, exact re-rank). ``encoder`` is
    anything with ``output(x)`` — a ``ParallelInference`` over a net — or
    a plain callable; documents added via ``add_documents`` are
    batch-encoded through it. ``device``: the card the store lives on
    (CUDA unless the caller passes another device). ``mesh`` (a
    ``parallel.mesh.Mesh`` with a ``data`` axis) shards the flat store
    and the IVF lists over its data entries; the merge and the host
    copies run on the first entry's device."""

    # The store snapshot is read lock-free by the coalescer/completer
    # loops (and sync searchers); every off-loop write swaps it under
    # ``_lock``.
    _LOOP_OWNED = ("_store",)
    _LOOP_LOCK = "_lock"

    def __init__(self, points=None, metric: str = "euclidean", *,
                 store: str = "f32", encoder=None, mesh=None,
                 partitions: Optional[int] = None, nprobe: int = 8,
                 list_cap: Optional[int] = None, train_sample: int = 65536,
                 kmeans_iters: int = 25, kmeans: str = "auto",
                 hnsw_m: int = 16, ef_construction: int = 64,
                 ef_search: int = 64, seed: int = 0,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 inflight: int = 2, max_pending: int = 256,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 chaos: Optional[ChaosPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 default_k: int = 10, device=None):
        if metric not in ("euclidean", "cosine"):
            raise ValueError(f"metric must be euclidean|cosine, got {metric}")
        if store not in ("f32", "int8", "hnsw"):
            raise ValueError(f"store must be f32|int8|hnsw, got {store}")
        if kmeans not in ("auto", "host", "sharded"):
            raise ValueError(
                f"kmeans must be auto|host|sharded, got {kmeans}")
        if kmeans == "sharded" and mesh is None:
            raise ValueError("kmeans='sharded' requires a mesh")
        if store == "hnsw" and (mesh is not None or partitions is not None):
            raise ValueError("store='hnsw' is host-resident: it composes "
                             "with neither mesh= nor partitions=")
        nprobe = int(nprobe)
        if nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        self.mesh = mesh
        self._entries = None if mesh is None else data_devices(mesh)
        self.device = (resolve_device(device) if mesh is None
                       else self._entries[0])
        self.metric = metric
        self.store_kind = store
        self.encoder = encoder
        self.partitions = None if partitions is None else int(partitions)
        # over-probing beyond the partition count clamps at build time
        # (nprobe = min(nprobe, C)); under-probing below 1 is the typed
        # ValueError above
        self.nprobe = nprobe
        self.list_cap = list_cap
        self.train_sample = int(train_sample)
        self.kmeans_iters = int(kmeans_iters)
        self.kmeans = kmeans
        self.hnsw_m = int(hnsw_m)
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)
        self.seed = int(seed)
        self.default_k = int(default_k)
        self.max_batch = int(max_batch)
        # the lever's fixed ceiling ("slots" in the tier_stats surface,
        # mirroring GenerationServer's slot pool)
        self.max_batch_pool = self.max_batch
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.inflight = max(1, int(inflight))
        self.admission = AdmissionController(max_pending)
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = (None if breaker is False
                        else breaker if breaker is not None
                        else CircuitBreaker())
        self._dispatch = (chaos.wrap(self._dispatch_knn) if chaos is not None
                          else self._dispatch_knn)
        self._chaos = chaos
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._m_dispatches = self.metrics.counter(
            "knn_dispatches_total", "device search programs issued")
        self._m_rejected_circuit = self.metrics.counter(
            "knn_rejected_circuit_total",
            "submits fast-failed by the open breaker")
        self._m_retried = self.metrics.counter(
            "knn_retried_total", "dispatch retry attempts")
        self._m_expired = self.metrics.counter(
            "knn_expired_total", "queries expired before dispatch")
        self._m_completed = self.metrics.counter(
            "knn_completed_total", "query futures resolved with rows")
        self._m_failed = self.metrics.counter(
            "knn_failed_total", "query futures resolved with a typed error")
        self._m_latency = self.metrics.histogram(
            "knn_latency_ms", "submit-to-resolution latency")
        self._m_batch_rows = self.metrics.histogram(
            "knn_batch_rows", "query rows per coalesced dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._m_recall = self.metrics.gauge(
            "knn_recall", "last measured recall vs exact (1.0 = exact)")
        self.metrics.gauge("knn_pending", "queries in flight",
                           fn=lambda: self.admission.pending)
        self.metrics.gauge("knn_resident_bytes",
                           "device bytes held by the vector store",
                           fn=lambda: self.resident_bytes)
        self.metrics.gauge("knn_points", "vectors in the store",
                           fn=lambda: self.n_points)
        self.metrics.gauge("knn_breaker_open",
                           "0 closed / 0.5 half-open / 1 open",
                           fn=self._breaker_level)
        self._drain_cv = threading.Condition()
        self._draining = False
        self._coalescer: Optional[ServingLoop] = None
        self._completer: Optional[ServingLoop] = None
        self._outstanding: set = set()
        self._lock = threading.Lock()
        self._closed = False
        # distinct (variant, bucket, kb[, nprobe]) keys dispatched: the
        # JAX package's compiled-program ledger, kept so ``stats()`` and
        # the batch-churn budget read the same here
        self._programs = BoundedCache()
        self._host: Optional[np.ndarray] = None
        self._store: Optional[_Store] = None
        if points is not None:
            self.add(points)

    # ------------------------------------------------------------- metrics
    def _breaker_level(self) -> float:
        if self.breaker is None:
            return 0.0
        return {"closed": 0.0, "half_open": 0.5,
                "open": 1.0}.get(self.breaker.state, 0.0)

    @property
    def n_points(self) -> int:
        st = self._store
        return 0 if st is None else st.n

    @property
    def dims(self) -> int:
        st = self._store
        return 0 if st is None else st.dim

    @property
    def resident_bytes(self) -> int:
        st = self._store
        return 0 if st is None else st.resident_bytes

    @property
    def dispatch_count(self) -> int:
        return int(self._m_dispatches.value)

    # ------------------------------------------------- autoscaler lever
    @property
    def active_slot_cap(self) -> int:
        """GenerationServer duck-type for FleetTierTarget: the knn
        tier's capacity knob is the coalescer's row cap."""
        return self.max_batch

    def set_active_slots(self, n: int) -> int:
        """Autoscaler lever (GenerationServer duck-type): moves the
        coalescer's ``max_batch`` row cap within [1, construction-time
        pool]. Bigger batches amortize the dispatch under load; smaller
        ones bound per-query latency."""
        self.max_batch = max(1, min(int(n), self.max_batch_pool))
        return self.max_batch

    # -------------------------------------------------------------- encode
    def encode(self, docs) -> np.ndarray:
        """Batch-encode documents into [N, D] f32 vectors through the
        attached encoder (``output(x)`` — e.g. ParallelInference — or a
        plain callable). With no encoder the docs ARE the vectors."""
        x = np.asarray(docs, np.float32)
        enc = self.encoder
        if enc is None:
            return np.atleast_2d(x)
        out = enc.output(x) if hasattr(enc, "output") else enc(x)
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        out = np.asarray(out, np.float32)
        if out.ndim != 2:
            out = out.reshape(out.shape[0], -1)
        return out

    def add_documents(self, docs) -> np.ndarray:
        """Encode ``docs`` and add the vectors; returns them. Encoding
        runs outside the index lock (it may be a full forward)."""
        vecs = self.encode(docs)
        self.add(vecs)
        return vecs

    def add(self, points) -> int:
        """Add [N, D] vectors: rebuild the (immutable) device store
        snapshot and swap it in atomically. Returns the new point count.
        IVF lists are rebuilt too — adds are a bulk-load operation here,
        not a hot path."""
        pts = np.atleast_2d(np.asarray(points, np.float32))
        if pts.ndim != 2:
            raise ValueError(f"points must be [N, D], got {pts.shape}")
        with self._lock:
            if self._closed:
                raise RuntimeError("EmbeddingIndex is closed")
            if self._host is not None:
                if pts.shape[1] != self._host.shape[1]:
                    raise ValueError(
                        f"dims mismatch: store is D={self._host.shape[1]}, "
                        f"got D={pts.shape[1]}")
                host = np.concatenate([self._host, pts])
            else:
                host = pts
            self._host = host
            self._store = self._build_store(host)
            return self._store.n

    # ------------------------------------------------------- store builder
    def _build_store(self, host: np.ndarray) -> _Store:
        n, d = host.shape
        if (self.store_kind == "f32" and self.partitions is None
                and self.mesh is None):
            # bitwise path: brute.py's upload arithmetic, and the search
            # side calls brute._knn with the same pad/bucket code
            return _Store("exact", n, d, _upload(host, self.metric,
                                                 self.device))
        pts = host
        if self.metric == "cosine":
            # normalize ONCE at build (host-side for the quantized /
            # partitioned variants; deterministic for bitwise rebuilds)
            nrm = np.maximum(
                np.linalg.norm(pts, axis=1, keepdims=True), 1e-12)
            pts = (pts / nrm).astype(np.float32)
        if self.store_kind == "hnsw":
            return self._build_hnsw(pts)
        if self.partitions is not None:
            return self._build_ivf(pts)
        return self._build_flat(pts)

    def _build_hnsw(self, pts: np.ndarray) -> _Store:
        from deeplearning4j_torch.nearestneighbors.hnsw import HNSWGraph

        n, d = pts.shape
        graph = HNSWGraph(pts, metric=self.metric, m=self.hnsw_m,
                          ef_construction=self.ef_construction,
                          seed=self.seed)
        return _Store("hnsw", n, d, (), graph=graph)

    def _put(self, a: np.ndarray):
        """Upload one store array to the index's device."""
        return torch.as_tensor(a, device=self.device)

    def _padded(self, pts: np.ndarray):
        """Rows padded to the mesh multiple (JAX's ``_padded``): the
        padded points and the aux vector, ||p||^2 for euclidean and 0 for
        cosine, +inf on the pad rows."""
        n, d = pts.shape
        m = self.mesh.size
        npad = -(-n // m) * m
        if npad != n:
            pts = np.concatenate([pts, np.zeros((npad - n, d), np.float32)])
        if self.metric == "cosine":
            aux = np.zeros(npad, np.float32)
        else:
            aux = np.sum(pts * pts, axis=1).astype(np.float32)
        aux[n:] = np.inf
        return pts, aux

    def _split(self, *arrays):
        """Axis 0 of each array cut into one contiguous block per data
        entry, each block uploaded to its entry's device: a list of
        per-entry tuples, and the first row of each block."""
        m = len(self._entries)
        rows = arrays[0].shape[0] // m
        shards = [tuple(torch.as_tensor(
            np.ascontiguousarray(a[e * rows:(e + 1) * rows]), device=dev)
            for a in arrays) for e, dev in enumerate(self._entries)]
        return shards, [e * rows for e in range(m)]

    def _build_sharded_flat(self, pts: np.ndarray) -> _Store:
        n, d = pts.shape
        padded, aux = self._padded(pts)
        if self.store_kind == "int8":
            q, scale = _quantize_rows(padded)
            if self.metric == "euclidean":
                deq = q.astype(np.float32) * scale[:, None]
                aux = np.where(np.isinf(aux), np.inf,
                               np.sum(deq * deq, axis=1)).astype(np.float32)
            shards, offsets = self._split(q, scale, aux)
            return _Store("int8", n, d, (), shards=shards, offsets=offsets)
        shards, offsets = self._split(padded, aux)
        if self.metric == "euclidean":
            # ||p||^2 summed on the device, as the unsharded store's upload
            # sums it (the pad rows keep their +inf)
            shards = [(p, torch.where(torch.isinf(a), a,
                                      torch.sum(p * p, dim=1)))
                      for p, a in shards]
        return _Store("aux", n, d, (), shards=shards, offsets=offsets)

    def _kmeans_sharded(self, sample: np.ndarray, C: int) -> np.ndarray:
        """Mesh-sharded centroid training (JAX's ``_kmeans_sharded``): the
        training rows split over the data entries, each Lloyd iteration
        one ``_kmeans_step``; deterministic init from ``seed`` (real
        rows), a host shift test per iteration (build path). Row padding
        repeats real rows, so the pad never mints a phantom centroid."""
        n, d = sample.shape
        m = self.mesh.size
        npad = -(-n // m) * m
        if npad != n:
            sample = np.concatenate(
                [sample, sample[np.resize(np.arange(n), npad - n)]])
        rng = np.random.RandomState(self.seed)
        centroids = np.ascontiguousarray(
            sample[rng.choice(n, C, replace=n < C)], np.float32)
        xs = [sh[0] for sh in self._split(sample)[0]]
        cs = [torch.as_tensor(centroids, device=dev)
              for dev in self._entries]
        with torch.inference_mode():
            for _ in range(self.kmeans_iters):
                cs, shift = _kmeans_step(xs, cs)
                if float(shift) <= 1e-6:
                    break
            return cs[0].cpu().numpy().astype(np.float32)

    def _build_flat(self, pts: np.ndarray) -> _Store:
        if self.mesh is not None:
            return self._build_sharded_flat(pts)
        n, d = pts.shape
        q, scale = _quantize_rows(pts)
        if self.metric == "euclidean":
            # exact ||p||^2 of the RECONSTRUCTED rows, so distances are
            # true distances to what the store actually holds
            deq = q.astype(np.float32) * scale[:, None]
            aux = np.sum(deq * deq, axis=1).astype(np.float32)
        else:
            aux = np.zeros(n, np.float32)
        return _Store("int8", n, d,
                      (self._put(q), self._put(scale), self._put(aux)))

    def _build_ivf(self, pts: np.ndarray) -> _Store:
        from deeplearning4j_torch.clustering.kmeans import KMeansClustering

        n, d = pts.shape
        C = max(1, min(self.partitions, n))
        rng = np.random.RandomState(self.seed)
        t = min(self.train_sample, n)
        sample = pts if t == n else pts[rng.choice(n, t, replace=False)]
        if self.mesh is not None and self.kmeans in ("auto", "sharded"):
            centroids = self._kmeans_sharded(sample, C)
        else:
            km = KMeansClustering(C, max_iterations=self.kmeans_iters,
                                  seed=self.seed, device=self.device)
            km.apply_to(sample)
            centroids = np.asarray(km.centers, np.float32)
        # chunked assignment on the card
        CH = min(65536, _pow2(n))
        assign = np.empty(n, np.int64)
        cdev = self._put(centroids)
        with torch.inference_mode():
            for s in range(0, n, CH):
                xb = self._put(np.ascontiguousarray(pts[s:s + CH]))
                assign[s:s + xb.shape[0]] = \
                    _assign_chunk(xb, cdev).cpu().numpy()
        counts = np.bincount(assign, minlength=C)
        M = _pow2(max(int(counts.max()), 1))
        if self.list_cap is not None:
            M = min(M, _pow2(self.list_cap))
        spilled = int(np.maximum(counts - M, 0).sum())
        # list layout: cell c holds its first M rows in point order (the
        # JAX package's stable sort), slot by slot
        order = np.argsort(assign, kind="stable")
        cell = assign[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(n) - starts[cell]
        keep = slot < M
        order, cell, slot = order[keep], cell[keep], slot[keep]
        ids = np.full((C, M), -1, np.int32)
        ids[cell, slot] = order
        quant = self.store_kind == "int8"
        if quant:
            # quantized in row chunks straight into the preallocated int8
            # store: per-row arithmetic, so bitwise the JAX package's
            # cell-by-cell build, with a transient of one chunk
            vecs = np.zeros((C, M, d), np.int8)
            scl = np.zeros((C, M), np.float32)
            lsq = np.zeros((C, M), np.float32)
            RCH = 1 << 20
            for s in range(0, order.size, RCH):
                o, c, sl = order[s:s + RCH], cell[s:s + RCH], slot[s:s + RCH]
                qr, sr = _quantize_rows(pts[o])
                deq = qr.astype(np.float32) * sr[:, None]
                vecs[c, sl] = qr
                scl[c, sl] = sr
                lsq[c, sl] = np.sum(deq * deq, axis=1)
        else:
            vecs = np.zeros((C, M, d), np.float32)
            vecs[cell, slot] = pts[order]
            lsq = np.sum(vecs * vecs, axis=2)
        cbias = np.zeros(C, np.float32)
        if self.metric == "cosine":
            laux = np.zeros((C, M), np.float32)
        else:
            laux = lsq.astype(np.float32)
        laux[ids < 0] = np.inf   # empty slots never win
        if self.mesh is not None:
            return self._shard_ivf(n, d, centroids, cbias, vecs,
                                   scl if quant else None, laux, ids,
                                   nprobe=min(self.nprobe, C), n_lists=C,
                                   list_len=M, spilled=spilled)
        return _Store("ivf", n, d,
                      (self._put(centroids), self._put(cbias),
                       self._put(vecs), self._put(scl) if quant else None,
                       self._put(laux), self._put(ids)),
                      nprobe=min(self.nprobe, C), n_lists=C, list_len=M,
                      spilled=spilled)

    def _shard_ivf(self, n, d, centroids, cbias, vecs, scl, laux, ids,
                   **meta) -> _Store:
        """The IVF lists split over the data entries, C/m cells each: C
        padded to the mesh multiple with empty, +inf-biased lists."""
        C = centroids.shape[0]
        Cpad = -(-C // self.mesh.size) * self.mesh.size
        if Cpad != C:
            extra = Cpad - C

            def pad(a, value):
                return np.concatenate(
                    [a, np.full((extra,) + a.shape[1:], value, a.dtype)])

            centroids, cbias = pad(centroids, 0), pad(cbias, np.inf)
            vecs, laux, ids = pad(vecs, 0), pad(laux, np.inf), pad(ids, -1)
            scl = None if scl is None else pad(scl, 0)
        arrays = (centroids, cbias, vecs, laux, ids) if scl is None \
            else (centroids, cbias, vecs, scl, laux, ids)
        shards, offsets = self._split(*arrays)
        if scl is None:   # one layout for the search: scales in slot 3
            shards = [sh[:3] + (None,) + sh[3:] for sh in shards]
        return _Store("ivf", n, d, (), shards=shards, offsets=offsets,
                      **meta)

    def _sharded_search(self, st: _Store, x: np.ndarray, kb: int,
                        nprobe: int):
        """Each entry's local top-kb (launched entry by entry, no host
        sync), then the one merge on the consumer's device."""
        ds, ids = [], []
        for dev, arrays, off in zip(self._entries, st.shards, st.offsets):
            qd = torch.as_tensor(x, device=dev)
            if st.variant == "ivf":
                q, qn = _ivf_query(qd, self.metric)
                d, i = _probe_local_rank(*arrays, q, qn, k=kb,
                                         nprobe=nprobe, metric=self.metric)
            else:
                local = _knn_aux if st.variant == "aux" else _knn_int8_local
                kk = min(kb, arrays[0].shape[0])
                d, i = local(*arrays, qd, k=kk, metric=self.metric)
                i = i + off
            ds.append(d)
            ids.append(i)
        return _merge_candidates(ds, ids, self.device, k=kb,
                                 metric=self.metric)

    # ------------------------------------------------------------ dispatch
    def _bucket_kb(self, k: int, st: _Store) -> int:
        kb = min(_pow2(k), st.n)
        if st.variant == "ivf":
            # the re-rank pool is nprobe*M candidates; k must fit it
            kb = min(kb, st.nprobe * st.list_len)
        return kb

    def _check_query(self, queries, k):
        """Typed validation shared by both entries: returns (q [Q, D] f32,
        k clamped to N, kb). Raises ValueError before any device work."""
        st = self._store
        if st is None:
            raise ValueError("EmbeddingIndex is empty: add vectors first")
        _check_k(k)
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if q.ndim != 2:
            raise ValueError(f"queries must be [Q, D], got {q.shape}")
        if q.shape[1] != st.dim:
            raise ValueError(f"dims mismatch: store is D={st.dim}, "
                             f"got D={q.shape[1]}")
        k = min(int(k), st.n)
        return q, k, self._bucket_kb(k, st)

    def _dispatch_knn(self, x, kb):
        """Pad the query rows to the pow2 bucket and launch ONE search;
        returns (distances, indices, CUDA event or None) un-fetched (the
        caller/completer strips the padding after the fetch). The
        pad/bucket arithmetic is DeviceBruteForceIndex.search_batch_arrays's."""
        st = self._store
        if st is None:
            raise ValueError("EmbeddingIndex is empty: add vectors first")
        x = _pad_queries(x)
        bucket = x.shape[0]
        if st.variant == "hnsw":
            # host graph walk: returns numpy, so the completer's "fetch"
            # is a no-op — no device program, but the same bucketed
            # signature keys the ledger
            self._record_program(("hnsw", bucket, kb))
            d, idx = st.graph.search_batch(x, kb, ef=self.ef_search)
            self._m_dispatches.inc()
            return d, idx, None
        with torch.inference_mode():
            if st.shards is not None:
                nprobe = 0
                if st.variant == "ivf":
                    nprobe = min(max(st.nprobe, -(-kb // st.list_len)),
                                 st.n_lists)
                self._record_program(
                    (st.variant if nprobe == 0 else "ivf_local", bucket,
                     kb) + ((nprobe,) if nprobe else ()))
                d, idx = self._sharded_search(st, x, kb, nprobe)
            elif st.variant == "exact":
                qd = self._put(x)
                points, sq = st.arrays
                self._record_program(("exact", bucket, kb))
                d, idx = _knn(points, sq, qd, k=kb, metric=self.metric)
            elif st.variant == "int8":
                qpts, scales, aux = st.arrays
                self._record_program(("int8", bucket, kb))
                d, idx = _knn_int8(qpts, scales, aux, self._put(x), k=kb,
                                   metric=self.metric)
            else:
                qd = self._put(x)
                nprobe = min(max(st.nprobe, -(-kb // st.list_len)),
                             st.n_lists)
                self._record_program(("ivf", bucket, kb, nprobe))
                d, idx = _knn_ivf(*st.arrays, qd, k=kb, nprobe=nprobe,
                                  metric=self.metric)
        event = None
        if d.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._m_dispatches.inc()
        return d, idx, event

    def _record_program(self, key) -> None:
        if key not in self._programs:
            self._programs[key] = True

    @staticmethod
    def _fetch_pair(out):
        """Wait for a launched search and copy it to the host: the one
        device->host sync per coalesced batch."""
        d, idx, event = out
        if event is not None:
            event.synchronize()
        if isinstance(d, torch.Tensor):
            return d.cpu().numpy(), idx.cpu().numpy()
        return d, idx

    # ---------------------------------------------------------- sync entry
    def search_batch_arrays(self, queries, k: int):
        """(distances [Q, k], indices [Q, k]) as numpy, nearest first —
        DeviceBruteForceIndex's contract (and, on the exact f32 path, its
        exact bytes)."""
        q, k, kb = self._check_query(queries, k)
        Q = q.shape[0]
        d, idx = self._fetch_pair(self._dispatch_knn(q, kb))
        return d[:Q, :k], idx[:Q, :k]

    def search_batch(self, queries, k: int) -> list:
        """VPTree.search_batch-compatible: per query a list of
        (distance, index) pairs, nearest first."""
        d, idx = self.search_batch_arrays(queries, k)
        return [[(float(dd), int(ii)) for dd, ii in zip(dr, ir)]
                for dr, ir in zip(d, idx)]

    def search(self, point, k: int):
        """[(distance, index), ...] for one query — VPTree.search shape."""
        d, idx = self.search_batch_arrays(
            np.asarray(point, np.float32)[None, :], k)
        return [(float(dd), int(ii)) for dd, ii in zip(d[0], idx[0])]

    def measure_recall(self, queries, k: int = 10) -> float:
        """Recall@k of this store vs an exact f32 search over the same
        points (the IVF/int8 acceptance gate). Builds a temporary exact
        view from the host copy on the index's device; publishes the
        ``knn_recall`` gauge."""
        with self._lock:
            host = self._host
        if host is None:
            raise ValueError("EmbeddingIndex is empty: add vectors first")
        q = np.atleast_2d(np.asarray(queries, np.float32))
        kk = min(int(k), host.shape[0])
        with torch.inference_mode():
            pts, sq = _upload(host, self.metric, self.device)
            _, exact = _knn(pts, sq, self._put(q), k=kk, metric=self.metric)
            exact = exact.cpu().numpy()
            del pts, sq
        _, got = self.search_batch_arrays(q, kk)
        hits = sum(len(np.intersect1d(exact[i], got[i]))
                   for i in range(q.shape[0]))
        recall = hits / float(exact.size)
        self._m_recall.set(recall)
        return recall

    # --------------------------------------------------------- async entry
    def submit(self, queries, k: Optional[int] = None, *,
               deadline_s: Optional[float] = None) -> Future:
        """Async k-NN: returns a Future of (distances [Q, k], indices
        [Q, k]). Concurrent submissions with the same (dims, k-bucket)
        signature are coalesced into ONE padded matmul+top-k dispatch and
        sliced back per caller; ``deadline_s``/admission/breaker behave
        exactly as ParallelInference.submit (typed DeadlineExceeded /
        ServerOverloaded / CircuitOpen, never a hang)."""
        q, k, kb = self._check_query(
            queries, self.default_k if k is None else k)
        with self._lock:
            if self._closed or self._draining:
                raise RuntimeError("EmbeddingIndex is closed"
                                   if self._closed else
                                   "EmbeddingIndex is draining")
            co = self._ensure_workers()
        if self.breaker is not None and not self.breaker.allow():
            self._m_rejected_circuit.inc()
            raise CircuitOpen("circuit breaker is open: recent dispatches "
                              "failed above threshold")
        self.admission.acquire()  # raises ServerOverloaded at watermark
        req = _QueryRequest(
            q, k, kb,
            None if deadline_s is None else Deadline(deadline_s))
        # single release point for admission + completion counters: fires
        # on EVERY resolution path, so pending can never leak
        req.future.add_done_callback(
            lambda f, t0=req.t0: self._on_done(f, t0))
        with self._lock:
            self._outstanding.add(req.future)
        try:
            co.put(req)
        except LoopClosed:
            with self._lock:
                closed = self._closed
            self._fail(req.future,
                       RuntimeError("EmbeddingIndex is closed") if closed
                       else LoopCrashed("knn-coalescer is restarting; "
                                        "resubmit the query"))
            return req.future
        with self._lock:
            closed = self._closed
        if closed and not req.future.done():
            self._fail(req.future, RuntimeError("EmbeddingIndex is closed"))
        return req.future

    def _on_done(self, fut: Future, t0: Optional[float] = None) -> None:
        with self._lock:
            self._outstanding.discard(fut)
        self.admission.release()
        if fut.exception() is None:
            self._m_completed.inc()
            if t0 is not None:
                self._m_latency.observe((time.monotonic() - t0) * 1e3)
        else:
            self._m_failed.inc()
        with self._drain_cv:
            self._drain_cv.notify_all()

    @staticmethod
    def _fail(future: Future, exc: Exception) -> None:
        try:
            future.set_exception(exc)
        except Exception:  # noqa: BLE001 — already resolved, either way
            pass

    # -------------------------------------------------------- runtime loops
    def _ensure_workers(self) -> ServingLoop:
        """Start the runtime loops once and return the coalescer. Caller
        holds ``self._lock``."""
        if self._coalescer is None:
            completer = ServingLoop(
                "knn-completer", handler=self._knn_complete_loop,
                inbox_maxsize=self.inflight,
                on_leftover=self._fail_inflight_leftover,
                chaos=self._chaos)
            coalescer = ServingLoop(
                "knn-coalescer", handler=self._knn_coalesce_entry,
                on_leftover=self._fail_submit_leftover,
                chaos=self._chaos)
            self._completer = completer
            self._coalescer = coalescer
            completer.start()
            coalescer.start()
            sup = supervisor()
            sup.watch(completer, on_death=self._on_loop_death, restart=True)
            sup.watch(coalescer, on_death=self._on_loop_death, restart=True)
        return self._coalescer

    def _on_loop_death(self, loop: ServingLoop, exc: BaseException):
        with self._lock:
            victims = list(self._outstanding)
            closed = self._closed
        err = LoopCrashed(f"{loop.name} died with the query in flight: "
                          f"{exc!r}")
        for f in victims:
            if not f.done():
                self._fail(f, err)
        return not closed

    def _fail_submit_leftover(self, req) -> None:
        self._fail(req.future, RuntimeError("EmbeddingIndex is closed"))

    def _fail_inflight_leftover(self, item) -> None:
        _out, batch = item
        for r in batch:
            self._fail(r.future, RuntimeError("EmbeddingIndex is closed"))

    def _expire_if_dead(self, req) -> bool:
        if req.deadline is None or not req.deadline.expired():
            return False
        self._m_expired.inc()
        self._fail(req.future, DeadlineExceeded(
            f"query expired {-req.deadline.remaining() * 1e3:.1f} ms "
            "before dispatch"))
        return True

    @staticmethod
    def _flush_by(d) -> float:
        """Latest instant the assembly window may run to for a member
        with deadline ``d`` (a quarter of the remaining budget is
        reserved for the dispatch itself)."""
        return d.expires_at - 0.25 * max(0.0, d.remaining())

    def _knn_coalesce_entry(self, first):
        with self._lock:
            co, completer = self._coalescer, self._completer
        return self._knn_coalesce_once(first, co, completer)

    def _knn_coalesce_once(self, first, co: ServingLoop,
                           completer: ServingLoop):
        """Coalescer handler: assemble ONE batch starting from ``first``
        and dispatch it; a signature mismatch flushes early and is
        carried back as this worker's next head."""
        if self._expire_if_dead(first):
            return None
        head = None
        batch = [first]
        rows = first.n
        sig = first.signature()
        deadline = time.monotonic() + self.max_wait_s
        if first.deadline is not None:
            deadline = min(deadline, self._flush_by(first.deadline))
        while rows < self.max_batch:
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            try:
                nxt = co.get(timeout=wait)
            except queue.Empty:
                break
            if nxt.signature() != sig:
                head = nxt
                break
            if self._expire_if_dead(nxt):
                continue
            batch.append(nxt)
            rows += nxt.n
            if nxt.deadline is not None:
                deadline = min(deadline, self._flush_by(nxt.deadline))
        self._knn_dispatch_batch(batch, completer)
        return head

    def _count_retry(self, attempt, exc) -> None:
        self._m_retried.inc()

    def _knn_dispatch_batch(self, batch, completer: ServingLoop):
        batch = [r for r in batch if not self._expire_if_dead(r)]
        if not batch:
            return
        self._m_batch_rows.observe(sum(r.n for r in batch))
        earliest = min((r.deadline for r in batch if r.deadline is not None),
                       key=lambda d: d.expires_at, default=None)
        kb = batch[0].kb

        def attempt():
            try:
                out = self._dispatch(x, kb)  # launched, not fetched
            except Exception:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            return out

        try:
            x = (batch[0].q if len(batch) == 1
                 else np.concatenate([r.q for r in batch]))
            out = self.retry.call(attempt, deadline=earliest,
                                  on_retry=self._count_retry)
        except Exception as e:  # noqa: BLE001 — surface on every future
            for r in batch:
                if not self._expire_if_dead(r):
                    self._fail(r.future, e)
            return
        while True:
            if completer.crashed is not None:
                err = LoopCrashed("knn-completer died with the batch in "
                                  "flight")
                for r in batch:
                    self._fail(r.future, err)
                return
            try:
                completer.put((out, batch), timeout=0.2)
                return
            except queue.Full:
                continue
            except LoopClosed:
                err = RuntimeError("EmbeddingIndex is closed")
                for r in batch:
                    self._fail(r.future, err)
                return

    def _knn_complete_loop(self, item):
        """Completer handler: one device fetch per coalesced batch,
        sliced back per caller (each future gets its own [n, k] rows,
        padding and k-bucket stripped)."""
        out, batch = item
        try:
            d, idx = self._fetch_pair(out)
        except Exception as e:  # noqa: BLE001
            for r in batch:
                self._fail(r.future, e)
            return None
        ofs = 0
        for r in batch:
            try:
                r.future.set_result((d[ofs:ofs + r.n, :r.k],
                                     idx[ofs:ofs + r.n, :r.k]))
            except Exception:  # noqa: BLE001 — lost a shutdown race
                pass
            ofs += r.n
        return None

    # ------------------------------------------------------------ lifecycle
    def stats(self) -> dict:
        """Serving + store counters, assembled entirely OUTSIDE the
        serving locks (every counter is a leaf-locked registry metric);
        the JAX index's keys in its order."""
        st = self._store
        out = {"retried": int(self._m_retried.value),
               "expired": int(self._m_expired.value),
               "rejected_circuit": int(self._m_rejected_circuit.value),
               "completed": int(self._m_completed.value),
               "failed": int(self._m_failed.value),
               "dispatches": int(self._m_dispatches.value),
               "programs": len(self._programs),
               "points": 0 if st is None else st.n,
               "dims": 0 if st is None else st.dim,
               "store": self.store_kind,
               "variant": "empty" if st is None else st.variant,
               "resident_bytes": 0 if st is None else st.resident_bytes,
               "recall": float(self._m_recall.value)}
        if st is not None and st.variant == "ivf":
            out.update(partitions=st.n_lists, list_len=st.list_len,
                       nprobe=st.nprobe, spilled=st.spilled,
                       probe_local=st.shards is not None)
        if st is not None and st.variant == "hnsw":
            out.update(hnsw_m=st.graph.m, ef_search=self.ef_search,
                       levels=st.graph.levels)
        out.update(
            accepted=self.admission.accepted,
            rejected=self.admission.rejected,
            pending=self.admission.pending,
            breaker_state=(self.breaker.state if self.breaker is not None
                           else "disabled"),
            # fleet tier_stats surface (FleetTierTarget's observation
            # keys): queue depth + the capacity lever's pool size
            queued=self.admission.pending,
            slots=self.max_batch_pool)
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admitting submits while every in-flight
        query resolves. Sync searches keep working — drain is a serving
        pause, not a store teardown."""
        with self._lock:
            self._draining = True
            co, cm = self._coalescer, self._completer
        if co is not None:
            co.begin_drain()
        if cm is not None:
            cm.begin_drain()
        limit = None if timeout is None else time.monotonic() + timeout
        while True:
            # liveness read OUTSIDE _drain_cv (the loop condition ranks
            # below it and may never be acquired while it is held)
            dead = co is None or (co.alive_workers == 0
                                  and (cm is None
                                       or cm.alive_workers == 0))
            with self._drain_cv:
                if self.admission.pending == 0:
                    return True
                if dead:
                    return False
                wait = 0.2 if limit is None else min(
                    0.2, limit - time.monotonic())
                if wait <= 0:
                    return False
                self._drain_cv.wait(wait)

    def close(self, timeout: float = 30.0):
        """Drain, then stop both runtime loops. Idempotent and
        re-entrant; every admitted future resolves — with rows or a
        typed error — before close returns."""
        with self._lock:
            should_drain = not self._closed and self._coalescer is not None
        if should_drain:
            self.drain(timeout)
        with self._lock:
            self._closed = True
            co, cm = self._coalescer, self._completer
        if co is None:
            return
        co.close(timeout)
        cm.close(timeout)
        co.fail_leftovers()
        with self._lock:
            victims = [f for f in self._outstanding if not f.done()]
        for f in victims:
            self._fail(f, RuntimeError("EmbeddingIndex is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
