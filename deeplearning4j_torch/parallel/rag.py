"""RagPipeline: retrieval-augmented generation as a two-tier fleet flow (the
port of ``deeplearning4j_torch/parallel/rag.py``).

``EmbeddingIndex`` and the paged ``GenerationServer`` are the two halves of
RAG, and this module composes them behind ONE ``submit() -> Future`` —
encode the query, retrieve
top-k from the knn tier, assemble the retrieved passages as a canonical
chunk-aligned prefix, generate on the generate tier::

    submit(prompt_ids, max_tokens) -> Future
        |
    RagPipeline ------------------- rag ledger + rag_ttft/retrieve/e2e
        |                           histograms (zero lost futures)
    ReplicaFleet (roles knn/generate)
        +-- knn tier:      EmbeddingIndex replicas (coalesced search)
        +-- generate tier: GenerationServer replicas (paged decode)

The fleet is the *same* disagg routing machinery the prefill/decode
tiers use — health-weighted scoring, typed shedding, supervised
restart, per-tier autoscaler levers (``tier_stats`` /
``set_tier_active_slots`` / ``FleetTierTarget``) — with the requests
role-pinned via ``submit(tier=...)`` instead of snapshot-staged.

Performance story: the vLLM-lineage prefix machinery (chunk-hashed COW
pages) plus the canonical passage order of
``assemble_passage_prefix`` mean concurrent requests retrieving the
same hot documents dedupe their prefill — popular passages become a de
facto device-resident KV *document cache*, observable through the
headline ``generation_prefix_hits_total`` /
``generation_prefix_tokens_reused_total`` counters (aggregated here as
``stats()["prefix_hits"]``/``["prefix_tokens_reused"]``).

Deadline propagation crosses the tier boundary: one request budget is
armed at submit, the knn dispatch gets the remaining budget, and the
generate dispatch gets what is left *after* retrieval — a request whose
budget died between tiers fails typed ``DeadlineExceeded`` without
costing a decode slot.

Invariant: **zero lost futures.** Every accepted request resolves with
tokens or a typed error from the resilience taxonomy, and the ledger
balances — ``submitted == completed + failed + expired + rejected``
once the pipeline is idle.

On the card the generate tier reads its pages through the hand-written
paged-attention kernel (K2): the chunk route for every prefill, the decode
route for every new token. Both tiers run on one card (``device``); a
replica a factory builds on another device is refused.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.parallel.fleet import ReplicaFleet
from deeplearning4j_torch.parallel.generation import assemble_passage_prefix
from deeplearning4j_torch.parallel.resilience import (AdmissionController,
                                                    Deadline,
                                                    DeadlineExceeded,
                                                    ServerOverloaded)

__all__ = ["RagPipeline"]


class _RagRequest:
    """One accepted RAG request: the generation call it will become,
    its single end-to-end deadline, and the caller-facing future."""

    __slots__ = ("prompt", "max_tokens", "temperature", "top_k", "seed",
                 "k", "deadline", "future", "t0", "t_retrieved", "docs",
                 "prefix_len", "gen_prompt")

    def __init__(self, prompt, max_tokens, temperature, top_k, seed, k,
                 deadline: Optional[Deadline]):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.k = k
        self.deadline = deadline
        self.future: Future = Future()
        self.t0 = time.monotonic()
        self.t_retrieved = 0.0
        self.docs: list = []
        self.prefix_len = 0
        self.gen_prompt = None


class RagPipeline:
    """Two-tier retrieval-augmented generation server.

    ``knn_factory(rid)`` builds a retrieval replica (``EmbeddingIndex``
    or anything with its ``submit(queries, k, deadline_s=) -> Future``
    contract); ``generate_factory(rid)`` builds a generation replica
    (``GenerationServer``). Both tiers live in ONE ``ReplicaFleet``
    with role-pinned routing, so each tier gets health-weighted
    least-loaded scoring, typed shedding, supervised restart, and its
    own autoscaler lever for free.

    ``passages`` is any indexable mapping doc id -> 1-D token ids (a
    list, an array, or a lazy ``__getitem__`` object for corpora too
    big to materialize). ``page_size`` MUST match the generation
    servers' so the assembled prefix is chunk-aligned to their page
    digests.

    ``device`` is the card both tiers run on (CUDA unless the caller
    passes another device): every replica a factory returns must live
    there (``EmbeddingIndex(..., device=)``, ``GenerationServer(...,
    device=)``).

    >>> rag = RagPipeline(knn_factory, generate_factory, passages,
    ...                   page_size=16, k=4)
    >>> fut = rag.submit(prompt_ids, 32, query_vec=q, deadline_s=5.0)
    >>> tokens = fut.result()       # fut._rag_docs / _rag_prefix_len /
    ...                             # _rag_prompt carry the retrieval
    """

    def __init__(self, knn_factory: Callable[[int], Any],
                 generate_factory: Callable[[int], Any],
                 passages, *, page_size: int = 16, pad_id: int = 0,
                 k: int = 4, encoder=None, knn_replicas: int = 1,
                 generate_replicas: int = 1, max_pending: int = 256,
                 registry: Optional[MetricsRegistry] = None,
                 request_deadline_s: Optional[float] = None,
                 fleet_kw: Optional[dict] = None, device=None):
        if int(knn_replicas) < 1 or int(generate_replicas) < 1:
            raise ValueError("each tier needs at least one replica")
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if int(page_size) < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.device = resolve_device(device)
        self._passages = passages
        self._ps = int(page_size)
        self._pad_id = int(pad_id)
        self._k = int(k)
        self._encoder = encoder
        self.request_deadline_s = request_deadline_s
        self._kr = int(knn_replicas)
        self._gr = int(generate_replicas)
        roles = ("knn",) * self._kr + ("generate",) * self._gr

        def factory(rid: int):
            srv = (knn_factory(rid) if rid < self._kr
                   else generate_factory(rid - self._kr))
            on = getattr(srv, "device", self.device)
            if on != self.device:
                raise ValueError(f"a RAG replica lives on {on}, the "
                                 f"pipeline on {self.device}; build the "
                                 "replicas on the pipeline's device")
            if rid < self._kr:
                return srv
            if getattr(srv, "role", None) == "unified":
                # unified-behaving server joining the generate tier: tag
                # it so the fleet's role-pinned route matches (the tag
                # changes routing only — no snapshot staging)
                srv.role = "generate"
            return srv

        fkw = dict(fleet_kw or {})
        fkw.setdefault("roles", roles)
        self.fleet = ReplicaFleet(factory,
                                  replicas=self._kr + self._gr, **fkw)
        self.admission = AdmissionController(max_pending)
        self._lock = threading.Lock()
        # drain parking lot: its OWN condition (never nested inside
        # self._lock), exactly EmbeddingIndex._drain_cv's shape
        self._idle = threading.Condition()
        self._inflight: set = set()
        self._closed = False

        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        m = self.metrics
        self._m_submitted = m.counter(
            "rag_submitted_total", "RAG requests offered")
        self._m_completed = m.counter(
            "rag_completed_total", "RAG requests completed with tokens")
        self._m_failed = m.counter(
            "rag_failed_total", "RAG requests failed typed")
        self._m_expired = m.counter(
            "rag_expired_total", "RAG requests failed on deadline")
        self._m_rejected = m.counter(
            "rag_rejected_total", "RAG submits shed before acceptance")
        self._h_retrieve = m.histogram(
            "rag_retrieve_ms", "submit to retrieval-complete (ms)")
        self._h_ttft = m.histogram(
            "rag_ttft_ms", "submit to first generated token (ms)")
        self._h_e2e = m.histogram(
            "rag_e2e_ms", "submit to final token (ms)")
        m.gauge("rag_pending", "accepted-but-unresolved RAG requests",
                fn=lambda: self.admission.pending)
        m.gauge("rag_k", "passages retrieved per request",
                fn=lambda: float(self._k))

    # ---------------------------------------------------------- encoding
    def _encode(self, prompt: np.ndarray) -> np.ndarray:
        enc = self._encoder
        if enc is None:
            raise ValueError(
                "no encoder attached: pass query_vec= explicitly")
        out = enc.output(prompt) if hasattr(enc, "output") else enc(prompt)
        return np.asarray(out, np.float32).ravel()

    # ------------------------------------------------------------ public
    def submit(self, prompt_ids, max_tokens: int, *,
               query_vec=None, k: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               deadline_s: Optional[float] = None) -> Future:
        """One RAG request: retrieve, assemble, generate. Returns a
        Future resolving to the generated ids (exactly what the
        generation tier would return for the assembled prompt — the
        bit-exactness contract vs a non-RAG reference). The retrieval
        metadata rides the future: ``_rag_docs`` (canonical doc order),
        ``_rag_prefix_len`` (shareable prefix tokens), ``_rag_prompt``
        (the full assembled prompt). Raises typed ``ServerOverloaded``
        at the admission watermark and ValueError on caller errors;
        every accepted request resolves typed — never a hang."""
        prompt = np.asarray(prompt_ids, np.int64).ravel()
        if prompt.size < 1:
            raise ValueError("prompt_ids must be a non-empty 1-D id array")
        if int(max_tokens) < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        kk = self._k if k is None else int(k)
        if kk < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        q = (self._encode(prompt) if query_vec is None
             else np.asarray(query_vec, np.float32).ravel())
        with self._lock:
            if self._closed:
                raise RuntimeError("RagPipeline is closed")
        budget = deadline_s if deadline_s is not None \
            else self.request_deadline_s
        self.admission.acquire()  # raises ServerOverloaded at watermark
        req = _RagRequest(prompt, int(max_tokens), float(temperature),
                          int(top_k), int(seed), kk,
                          None if budget is None else Deadline(budget))
        req.future.add_done_callback(lambda _f: self.admission.release())
        self._m_submitted.inc()
        with self._lock:
            if self._closed:
                self._finish(req, None,
                             RuntimeError("RagPipeline is closed"))
                return req.future
            self._inflight.add(req)
        # tier 1: retrieval, with the remaining budget
        try:
            kfut = self.fleet.submit(
                q[None, :], kk, tier="knn",
                deadline_s=self._remaining(req))
        except Exception as e:
            # typed shed at the knn tier (overloaded/breaker/dark): the
            # request was never accepted downstream — count it rejected
            # and re-raise synchronously, like the servers do
            self._finish(req, None, e, rejected=True)
            raise
        kfut.add_done_callback(partial(self._rag_retrieve_done, req))
        return req.future

    def _remaining(self, req: _RagRequest) -> Optional[float]:
        """Remaining request budget for the next tier dispatch (the
        cross-tier deadline propagation). Clamped above zero so an
        expired-in-flight budget still dispatches once and fails with
        the dispatching tier's typed DeadlineExceeded."""
        if req.deadline is None:
            return None
        rem = req.deadline.remaining()
        return rem if rem > 0.001 else 0.001

    # ----------------------------------------------------- tier boundary
    def _rag_retrieve_done(self, req: _RagRequest, fut: Future) -> None:
        """Knn-tier completion (runs on the index completer or fleet
        threads). Routes the request across the tier boundary: observe
        retrieval latency, then assemble + dispatch generation."""
        if fut.cancelled():
            self._finish(req, None, RuntimeError(
                "retrieval attempt cancelled"))
            return
        exc = fut.exception()
        if exc is not None:
            self._finish(req, None, exc)
            return
        req.t_retrieved = time.monotonic()
        self._h_retrieve.observe((req.t_retrieved - req.t0) * 1000.0)
        _dists, ids = fut.result()
        self._rag_assemble_dispatch(req, ids)

    def _rag_assemble_dispatch(self, req: _RagRequest, ids) -> None:
        """Assemble the canonical passage prefix and dispatch the
        generate tier with the post-retrieval remaining budget (the
        id/token coercions live in ``assemble_passage_prefix``)."""
        try:
            prompt, docs, plen = assemble_passage_prefix(
                ids, self._passages, page_size=self._ps,
                pad_id=self._pad_id, query_ids=req.prompt)
            req.gen_prompt = prompt
            req.docs = docs
            req.prefix_len = plen
            if req.deadline is not None and req.deadline.expired():
                raise DeadlineExceeded(
                    "request budget exhausted after retrieval, before "
                    "the generate-tier dispatch")
            gfut = self.fleet.submit(
                prompt, req.max_tokens, tier="generate",
                temperature=req.temperature, top_k=req.top_k,
                seed=req.seed, deadline_s=self._remaining(req))
        except Exception as e:  # noqa: BLE001 — every path resolves typed
            self._finish(req, None, e)
            return
        gfut.add_done_callback(partial(self._rag_generate_done, req))

    def _rag_generate_done(self, req: _RagRequest, fut: Future) -> None:
        """Generate-tier completion: observe TTFT off the propagated ``_t_first`` stamp and resolve
        the caller future with the generated ids."""
        if fut.cancelled():
            self._finish(req, None, RuntimeError(
                "generation attempt cancelled"))
            return
        exc = fut.exception()
        if exc is not None:
            self._finish(req, None, exc)
            return
        tf = getattr(fut, "_t_first", None)
        if tf is not None and tf > req.t0:
            self._h_ttft.observe((tf - req.t0) * 1000.0)
        self._finish(req, fut.result(), None)

    # --------------------------------------------------------- resolution
    def _finish(self, req: _RagRequest, value, exc,
                *, rejected: bool = False) -> None:
        """Resolve the caller future exactly once and keep the ledger
        balanced: submitted == completed + failed + expired + rejected
        once idle (zero lost futures)."""
        with self._lock:
            linked = req in self._inflight
            self._inflight.discard(req)
        with self._idle:
            self._idle.notify_all()
        if not linked and req.future.done():
            return
        if rejected:
            self._m_rejected.inc()
        elif exc is None:
            self._m_completed.inc()
            self._h_e2e.observe((time.monotonic() - req.t0) * 1000.0)
        elif isinstance(exc, DeadlineExceeded):
            self._m_expired.inc()
        else:
            self._m_failed.inc()
        try:
            if exc is None:
                req.future._rag_docs = req.docs
                req.future._rag_prefix_len = req.prefix_len
                req.future._rag_prompt = req.gen_prompt
                req.future.set_result(value)
            else:
                req.future.set_exception(exc)
        except Exception:  # noqa: BLE001 — caller cancelled: outcome dropped
            pass

    # ---------------------------------------------------------- observers
    def tier_stats(self, role: str) -> dict:
        """Per-tier queue/outcome aggregates (the autoscaler lever's
        observation surface) — delegates to the fleet."""
        return self.fleet.tier_stats(role)

    def set_tier_active_slots(self, role: str, n: int) -> int:
        """Per-tier capacity lever — delegates to the fleet."""
        return self.fleet.set_tier_active_slots(role, n)

    def _prefix_counters(self) -> Tuple[int, int]:
        hits = reused = 0
        for srv in self.fleet.tier_replicas("generate"):
            try:
                pages = srv.stats().get("pages", {})
            except Exception:  # noqa: BLE001 — replica mid-death
                continue
            hits += int(pages.get("prefix_hits", 0))
            reused += int(pages.get("prefix_tokens_reused", 0))
        return hits, reused

    def stats(self) -> dict:
        """RAG ledger + headline document-cache counters + per-tier
        aggregates, with the JAX pipeline's keys in its order."""
        with self._lock:
            inflight = len(self._inflight)
        hits, reused = self._prefix_counters()
        return {
            "submitted": int(self._m_submitted.value),
            "completed": int(self._m_completed.value),
            "failed": int(self._m_failed.value),
            "expired": int(self._m_expired.value),
            "rejected": int(self._m_rejected.value),
            "inflight": inflight,
            "k": self._k,
            "page_size": self._ps,
            "prefix_hits": hits,
            "prefix_tokens_reused": reused,
            "tiers": {"knn": self.fleet.tier_stats("knn"),
                      "generate": self.fleet.tier_stats("generate")},
        }

    def metrics_sources(self) -> List[Tuple[Dict[str, str],
                                            MetricsRegistry]]:
        """One-scrape exposition sources: the rag ledger and the fleet
        aggregates unlabeled, each tier replica's registry labeled
        ``tier=knn``/``tier=generate`` — so a single GET /metrics pass
        renders ``rag_ttft_ms`` next to the knn tier's ``knn_recall``
        and the generate tier's prefix counters."""
        out: List[Tuple[Dict[str, str], MetricsRegistry]] = [
            ({}, self.metrics), ({}, self.fleet.metrics)]
        for role in ("knn", "generate"):
            for srv in self.fleet.tier_replicas(role):
                reg = getattr(srv, "metrics", None)
                if reg is not None:
                    out.append(({"tier": role}, reg))
        return out

    # ---------------------------------------------------------- lifecycle
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted RAG request resolved (including
        requests between tiers, which the fleet no longer tracks)."""
        dl = None if timeout is None else Deadline(timeout)
        while True:
            with self._lock:
                if not self._inflight:
                    return True
            if dl is not None and dl.expired():
                return False
            wait = 0.1
            if dl is not None:
                wait = min(wait, max(0.001, dl.remaining()))
            with self._idle:
                self._idle.wait(wait)

    def close(self, timeout: float = 30.0) -> None:
        """Drain, close the fleet, and fail any straggler typed.
        Idempotent; zero lost futures across shutdown."""
        with self._lock:
            already = self._closed
            self._closed = True
        if not already:
            self.drain(timeout)
        self.fleet.close(timeout)
        with self._lock:
            leftovers = list(self._inflight)
        err = RuntimeError("RagPipeline closed with the request in flight")
        for req in leftovers:
            self._finish(req, None, err)

    def __enter__(self) -> "RagPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
