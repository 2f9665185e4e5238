"""Continuous-batching generation serving over a PAGED KV-cache pool (port of
``deeplearning4j_tpu/parallel/generation.py``).

``GenerationServer`` runs iteration-level (continuous) batching over a fixed
pool of S decode slots and stores every slot's KV cache in a shared pool of
fixed-size pages behind a block table:

- The device keeps one ``[pages, H, page_size, d]`` K/V pool per attention
  layer (plus ``[pages, H, page_size]`` f32 scale planes under
  ``kv_dtype="int8"``). A host-owned ``[S, max_pages]`` int32 block table
  maps each slot to its pages and rides into every forward as data. Page 0
  is the garbage page that inactive rows and padded columns write into.
- PREFIX SHARING (``prefix_cache=True``): prompts are hashed per page-aligned
  chunk under a chained SHA-1 digest; a prompt whose leading chunks match
  pages already resident shares them, refcounted and read-only, and
  prefills only its suffix (from ``pos = matched``, so the paged read walks
  the shared pages). Shared and prefix-cache-registered pages are
  copy-on-write: the first write into one (a request's own first decode
  token landing in its registered tail page included) copies the page, every
  leaf of every layer with the int8 scale planes, into a fresh page and
  repoints the block table. Released cached pages stay resident for future
  matches until the pool runs dry and evicts them, oldest first.
- Admission is page accounting: ``submit()`` rejects a request whose prompt
  + max_tokens (+ the speculative look-ahead) can never fit with a typed
  ``ServerOverloaded`` up front. Under transient pressure the newest
  admitted slot is PREEMPTED: its pages are freed and its request goes back
  to the front of the queue. A victim with at least a page of decoded
  tokens snapshots first and resumes by adoption; otherwise it recomputes
  from token 0. The key schedule makes either path give the same tokens.
- A wave of admitted prompts is prefilled together, Sarathi-style: rounds of
  at most ``prefill_chunk`` tokens per row, one batched paged forward per
  round, rows not in the wave routed to the garbage page.
- Each decode dispatch advances every active slot ``steps_per_dispatch``
  micro-steps, each a paged forward through the paged-attention kernel,
  with ONE ``[S, M]`` token copy to the host per dispatch. Rows write-clamp
  at capacity: a row at ``NP * page_size`` freezes and its block-table row
  swaps to the garbage page.
- SPECULATIVE DECODING (``draft_net`` + ``spec_k``): a small draft model
  with a dense ``[S, H, cap, d]`` slot cache proposes ``spec_k - 1`` tokens
  per slot under the same key schedule, and the target verifies all
  ``spec_k`` positions in ONE chunked paged forward (the paged read at
  ``T = spec_k``). Emitted tokens are always the target's selections under
  the serial schedule, so outputs equal the non-speculative server's
  whatever the draft proposes; the draft only buys throughput (the accept
  rate is in ``stats()``).
- Deadlines (``submit(..., deadline_s=)`` or the server-wide
  ``request_deadline_s``) fail queued and resident requests alike with a
  typed ``DeadlineExceeded``, checked between dispatches.
- Snapshots and handoff (``parallel/handoff.py``): ``snapshot_every`` N
  tokens a slot's state is exported as a ``KVSnapshot`` and attached to its
  future (``future._kv_snapshot``); ``export_request`` snapshots a live
  request between dispatches; ``adopt_request`` resumes a snapshot (either
  package's) at position N, sharing pages whose digest is resident and
  storing the rest in one scatter. Serving ROLES split prefill from decode:
  a ``role="prefill"`` server (or ``submit(..., export_kv=True)``) resolves
  a request's future to the ``KVSnapshot`` holding its first token and
  frees the slot, and a decode-role server adopts it. ``drain(migrate=
  True)`` moves every live request off the server as a snapshot attached
  to a ``RequestMigrated`` failure.

Requests are greedy or sampled (``temperature``, ``top_k``, ``seed``). A
request's token i is selected with ``fold_in(PRNGKey(seed), i)`` (the
threefry keys of ``ops/random.py``), the JAX server's serial key schedule,
so its stream equals ``sample_generate``'s and the JAX server's for the same
probabilities. A dispatch whose active rows are all greedy takes the plain
argmax, as the JAX server's ``lax.cond`` does.

The decode loop runs as a supervised ``ServingLoop`` (``parallel/
runtime.py``): a loop thread that dies (a chaos kill, an untrappable fault)
fails its in-flight futures typed, the device state is rebuilt and the
loop restarts. Every dispatch (prefill round, decode dispatch, draft
prefill, speculative round) runs under the ``ChaosPolicy`` injector when
one is given, the ``CircuitBreaker``'s accounting and the ``RetryPolicy``;
a retried dispatch re-runs on the same inputs and rewrites the same pool
slots with the same values, since no host state advances before it
returns. Counters live in a ``MetricsRegistry`` under the JAX server's
metric names, and ``stats()`` has the JAX server's keys in its order.
TENSOR-PARALLEL serving (``mesh=`` with a ``model`` axis, or ``tp=``):
every attention layer's pool is split by heads, shard i a ``[pages, H/tp,
page_size, d]`` pool on the mesh's i-th device (``pages`` is the budget of
each shard); weights, activations and the block table stay on the mesh's
first device, and the only collective is the exact all-gather of the
disjoint per-head contexts before Wo, so streams are bitwise the
one-device server's at every tp. Snapshots gather the shards into the
canonical ``[NP, H, ps, d]`` layout (header ``shards=tp``) and adoption
splits them by this server's tp. Without a mesh the pool is one shard of
every head on the server's device: one write-and-read path serves every
tp.
``assemble_passage_prefix`` (the JAX package's, verbatim) lays retrieved
passages out as a canonical page-aligned prompt prefix for RAG
(``parallel/rag.py``).
Snapshots of bf16 pools carry their pages as raw 16-bit words labelled
``bfloat16``, as the JAX package's do.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.metrics.registry import MetricsRegistry
from deeplearning4j_torch.models.zoo import (lm_stream_forward,
                                             sampled_next_token,
                                             spec_verify_tokens)
from deeplearning4j_torch.nn.conf.layers.attention import (
    PositionalEncodingLayer, SelfAttentionLayer)
from deeplearning4j_torch.nn.conf.layers.paged_attention import CHOICES
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.optimize.bucketing import bucket_pages
from deeplearning4j_torch.parallel.handoff import (BF16_WIRE, WIRE_VERSION,
                                                   KVSnapshot,
                                                   RequestMigrated,
                                                   SnapshotInvalid,
                                                   SnapshotUnavailable,
                                                   SnapshotUnsupported,
                                                   corrupt_snapshot,
                                                   pack_snapshot,
                                                   truncate_snapshot)
from deeplearning4j_torch.parallel.mesh import (MODEL_AXIS, Mesh,
                                                MeshGeometryError,
                                                Replicas, all_gather,
                                                model_mesh)
from deeplearning4j_torch.parallel.resilience import (AdmissionController,
                                                      ChaosPolicy,
                                                      CircuitBreaker,
                                                      CircuitOpen, Deadline,
                                                      DeadlineExceeded,
                                                      RetryPolicy,
                                                      ServerOverloaded)
from deeplearning4j_torch.parallel.runtime import (CLOSED, DRAINING,
                                                   LoopCrashed, ServingLoop,
                                                   supervisor)

_UNSET = object()

#: pool page 0 never backs real tokens: inactive slots' block-table rows
#: are all zeros, so their masked garbage writes land here
GARBAGE_PAGE = 0


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A host tensor as a KVSnapshot payload leaf: bf16 as its raw words
    under ``BF16_WIRE``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WIRE)
    return t.numpy()


def _from_wire(a: np.ndarray) -> torch.Tensor:
    """A KVSnapshot payload leaf as a host tensor (``_to_wire``'s
    inverse)."""
    a = np.ascontiguousarray(a)
    if (a.dtype.metadata or {}).get("wire") == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def assemble_passage_prefix(doc_ids, passages, *, page_size: int,
                            pad_id: int = 0, query_ids=None):
    """Assemble retrieved passages into a canonical chunk-aligned prompt
    prefix — the admission contract that turns the prefix cache into a
    device-resident document cache.

    Two rules make the page digests collide exactly when the content
    does (``_match_prefix`` hashes ``page_size`` chunks under a chained
    digest, so byte-identical leading pages are the sharing unit):

    - **Canonical order.** Retrieved doc ids are deduplicated and
      sorted ascending, so every request hitting the same documents
      assembles the same byte stream regardless of retrieval-score
      order. Under a skewed (Zipf) query mix the hot documents sort
      first, giving concurrent requests long shared leading runs.
    - **Chunk alignment.** Each passage is padded to a ``page_size``
      multiple with ``pad_id``, so a passage always starts on a page
      boundary and its pages hash identically no matter which
      passages precede it in the shared run.

    Negative ids (IVF empty-slot padding) are dropped. ``query_ids``
    (the user's own prompt tokens) are appended unpadded after the
    prefix — they are per-request and never shared.

    Returns ``(prompt_ids int64, doc_order, prefix_len)``: the full
    prompt, the canonical doc order actually assembled, and how many
    leading tokens are shareable passage prefix."""
    ps = int(page_size)
    if ps < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    order = sorted({int(i) for i in np.asarray(doc_ids).ravel()
                    if int(i) >= 0})
    parts = []
    for d in order:
        p = np.asarray(passages[d], np.int64).ravel()
        if p.size == 0:
            continue
        pad = -p.size % ps
        if pad:
            p = np.concatenate([p, np.full(pad, int(pad_id), np.int64)])
        parts.append(p)
    prefix = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    plen = int(prefix.size)
    if query_ids is not None:
        q = np.asarray(query_ids, np.int64).ravel()
        prompt = np.concatenate([prefix, q]) if plen else q
    else:
        prompt = prefix
    return prompt, order, plen


class _Request:
    __slots__ = ("prompt", "max_tokens", "temperature", "top_k", "seed",
                 "eos_id", "deadline", "future", "tokens", "snapshot",
                 "export_kv")

    def __init__(self, prompt, max_tokens, temperature, top_k, seed, eos_id,
                 deadline=None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.eos_id = eos_id
        self.deadline = deadline
        self.future = Future()
        self.tokens: list = []
        # a KVSnapshot to resume from instead of prefilling from token 0
        # (set by adopt_request and by a preemption that saved its state)
        self.snapshot = None
        # disaggregated prefill: after prefill, the future resolves to the
        # slot's KVSnapshot instead of decoding here
        self.export_kv = False


class _PagePool:
    """Host-side accounting for the device page pool: a free stack,
    per-page refcounts, and an LRU prefix cache mapping chained content
    digests to resident pages. Page 0 is the reserved garbage page. Owned
    by the serving loop thread."""

    def __init__(self, pages: int):
        self.total = int(pages)
        self.free = list(range(self.total - 1, 0, -1))  # pop() -> page 1
        self.ref = [0] * self.total
        self.cache: OrderedDict = OrderedDict()  # digest -> page (LRU)
        self.tag: dict = {}                      # page -> digest
        self.evictions = 0
        self.peak = 0

    def in_use(self) -> int:
        """Pages holding live data: refcounted by a slot or retained by the
        prefix cache (reclaimable, but resident)."""
        return self.total - 1 - len(self.free)

    def alloc(self) -> Optional[int]:
        """One page at refcount 1, evicting the oldest reclaimable cached
        page when the free list is dry; None when exhausted."""
        if not self.free:
            for digest, page in list(self.cache.items()):  # oldest first
                if self.ref[page] == 0:
                    self._uncache(digest, page)
                    self.evictions += 1
                    break
        if not self.free:
            return None
        page = self.free.pop()
        self.ref[page] = 1
        self.peak = max(self.peak, self.in_use())
        return page

    def _uncache(self, digest: bytes, page: int) -> None:
        del self.cache[digest]
        del self.tag[page]
        if self.ref[page] == 0:
            self.free.append(page)

    def share(self, page: int) -> None:
        self.ref[page] += 1

    def release(self, page: int) -> None:
        self.ref[page] -= 1
        if self.ref[page] == 0 and page not in self.tag:
            self.free.append(page)

    def protected(self, page: int) -> bool:
        """True when a write to ``page`` must copy first: another slot or
        the prefix cache depends on its current content."""
        return self.ref[page] > 1 or page in self.tag

    def lookup(self, digest: bytes) -> Optional[int]:
        page = self.cache.get(digest)
        if page is not None:
            self.cache.move_to_end(digest)
        return page

    def register(self, digest: bytes, page: int) -> None:
        """Publish ``page`` for future prefix matches. No-op when the digest
        is already cached (the pristine original wins) or the page is
        already tagged."""
        if digest in self.cache or page in self.tag:
            return
        self.cache[digest] = page
        self.tag[page] = digest

    def shared_count(self) -> int:
        return sum(1 for r in self.ref if r > 1)

    def refcounted(self) -> int:
        return sum(1 for r in self.ref if r > 0)


class GenerationServer:
    """Paged continuous-batching decode server for a causal LM, greedy or
    sampled per request.

    ``net`` is a port ``ComputationGraph`` whose attention layers page their
    KV (TransformerLM). ``submit`` returns a ``concurrent.futures.Future``
    resolving to the generated token ids (numpy int64, EOS included when
    hit). ``device`` defaults to CUDA and must be the net's device.

    ``page_size`` must divide the attention ``max_cache``; ``pages`` defaults
    to ``slots * max_cache / page_size + 1`` (every slot at full capacity
    plus the garbage page; set lower to serve in less memory, with
    preemption under pressure). ``prefix_cache`` toggles chunk-hash prefix
    sharing. ``paged_attention`` (None keeps each layer's knob) is pushed
    onto every paged layer and restored on close. ``request_deadline_s`` is
    the default budget of a request; ``snapshot_every`` N > 0 attaches a
    ``KVSnapshot`` to a slot's future every N generated tokens.

    Speculative decoding: pass a small ``draft_net`` (same vocab, on the
    server's device, ``max_cache`` at least the target's) and ``spec_k >=
    2``; each round the draft proposes ``spec_k - 1`` tokens and the target
    verifies all ``spec_k`` positions in one chunked paged forward.

    ``role`` is ``"unified"`` (prefill and decode here), ``"prefill"``
    (submits default to ``export_kv=True``: the future resolves to the
    prefilled request's ``KVSnapshot``), ``"decode"`` or ``"generate"``
    (tier labels; both serve adoptions and plain submits). ``retry``,
    ``breaker`` and ``chaos`` guard every dispatch (defaults: a
    ``RetryPolicy()``, a ``CircuitBreaker()``, no chaos); ``registry``
    receives the server's metrics (default: a registry of its own, at
    ``self.metrics``).

    ``mesh`` (a ``parallel/mesh.py`` ``Mesh`` with a ``model`` axis) or
    ``tp`` (``model_mesh(tp)`` over the CUDA devices) serves
    tensor-parallel: the KV pools shard by heads over the mesh's devices
    and the server runs on its first device (a ``device=`` naming another
    raises). A net living elsewhere is replicated onto that device, so
    replica groups of a fleet may share one net.
    """

    # Decode-loop-owned state (conc-loop-ownership, see
    # analysis/concurrency_rules.py): every write happens under ``_cond``
    # but the tick thread reads it lock-free between dispatches.
    _LOOP_OWNED = ("_slot_req",)
    _LOOP_LOCK = "_cond"

    def __init__(self, net, vocab: int, *, slots: int = 8,
                 eos_id: Optional[int] = None,
                 max_pending: int = 64,
                 request_deadline_s: Optional[float] = None,
                 min_prefill_bucket: int = 8,
                 prefill_chunk: int = 256,
                 page_size: int = 16,
                 pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 steps_per_dispatch: int = 4,
                 kv_dtype: Optional[str] = None,
                 paged_attention: Optional[str] = None,
                 mesh=None,
                 tp: Optional[int] = None,
                 draft_net=None,
                 spec_k: int = 4,
                 snapshot_every: int = 0,
                 role: str = "unified",
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 chaos: Optional[ChaosPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{steps_per_dispatch}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(None or 'int8')")
        if paged_attention is not None and paged_attention not in CHOICES:
            raise ValueError(f"unsupported paged_attention "
                             f"{paged_attention!r} (None or one of "
                             f"{CHOICES})")
        # the draft's dense cache is not part of the KVSnapshot wire format,
        # so a speculative server can neither snapshot nor export
        if snapshot_every and draft_net is not None:
            raise ValueError(
                "snapshot_every is incompatible with draft_net: the "
                "speculative draft's dense KV cache is not part of the "
                "KVSnapshot wire format")
        if role not in ("unified", "prefill", "decode", "generate"):
            raise ValueError(f"role must be 'unified', 'prefill', "
                             f"'decode' or 'generate', got {role!r}")
        if role == "prefill" and draft_net is not None:
            raise ValueError(
                "role='prefill' is incompatible with draft_net: the "
                "exported KVSnapshot cannot carry the draft's dense "
                "KV cache")
        mesh = self._resolve_mesh(mesh, tp)
        self._tp = 1 if mesh is None else mesh.size
        self._replicas = Replicas(net)
        if mesh is None:
            self.device = resolve_device(device)
            if net.device != self.device:
                raise ValueError(f"the net lives on {net.device}, the server "
                                 f"on {self.device}; init the net on the "
                                 "server's device")
        else:
            self.device = mesh.flat[0]
            if device is not None and resolve_device(device) != self.device:
                raise MeshGeometryError(
                    f"device={device} disagrees with the mesh, whose first "
                    f"device {self.device} hosts the server")
        # the devices of the pool's head shards (one without a mesh)
        self._shard_devices = [self.device] if mesh is None else mesh.flat
        self.net = net
        self.vocab = int(vocab)
        self.slots = int(slots)
        self.eos_id = eos_id
        self.request_deadline_s = request_deadline_s
        self.min_prefill_bucket = int(min_prefill_bucket)
        self.prefill_chunk = int(prefill_chunk)
        self.prefix_cache = bool(prefix_cache)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.kv_dtype = kv_dtype
        self.paged_attention = paged_attention
        self.snapshot_every = max(0, int(snapshot_every))
        self.spec_k = int(spec_k)
        self.role = role
        self.admission = AdmissionController(max_pending)
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._chaos = chaos
        self._ps = int(page_size)
        # prefill rounds advance at most this many (page-aligned) tokens
        # per row and dispatch
        self._chunk_cap = max(self._ps,
                              self.prefill_chunk // self._ps * self._ps)
        self._probe_net()
        if pages is None:
            pages = self.slots * self._np + 1
        self.pages_total = int(pages)
        if self.pages_total < 2:
            raise ValueError(f"pages={self.pages_total} must be >= 2 "
                             "(the reserved garbage page + one usable)")
        self._page_bytes = self._page_token_bytes * self._ps
        self._draft = draft_net
        if draft_net is not None:
            if self.spec_k < 2:
                raise ValueError(f"spec_k must be >= 2 (one verified "
                                 f"chunk needs at least one draft token), "
                                 f"got {self.spec_k}")
            self._probe_draft()
        # decode-write look-ahead per dispatch: M fused micro-steps, or the
        # K-token speculative chunk
        self._lookahead = self.spec_k if draft_net is not None \
            else self.steps_per_dispatch

        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._slot_req: list = [None] * self.slots
        self._n_active = 0
        self._active_cap = self.slots
        # a deliberate close() (as opposed to a crash-forced CLOSED state):
        # the supervisor restarts the loop only while this is False
        self._user_close = False

        # host mirrors of the per-slot decode state (loop-thread-owned)
        self._last = np.zeros(self.slots, np.int64)
        self._pos = np.zeros(self.slots, np.int32)
        # per-slot sampling: the index of the slot's next token, its
        # temperature and top_k, and its base key PRNGKey(seed)
        self._counts = np.zeros(self.slots, np.int64)
        self._temp = np.zeros(self.slots, np.float32)
        self._topk = np.zeros(self.slots, np.int64)
        self._keys = np.zeros((self.slots, 2), np.int64)
        self._bt = np.zeros((self.slots, self._np), np.int32)
        self._slot_pages: list = [[] for _ in range(self.slots)]
        # admission order of the resident slots (the newest is the
        # preemption victim) and each slot's token count at its last
        # snapshot
        self._slot_seq = [0] * self.slots
        self._admit_seq = 0
        self._snap_counts = [0] * self.slots
        # export_request handshakes ((request future, out future) pairs the
        # loop services between dispatches) and the drain-migrate flag
        self._export_q: deque = deque()
        self._migrating = False
        self._migrate_cb = None
        self._page_pool = _PagePool(self.pages_total)
        # prefill rounds dispatched (not a stats() key: the JAX server has
        # none; chip_smoke.py holds K2's launch count to it)
        self._prefill_rounds = 0
        self._register_metrics(registry)
        # the gauges read loop state lock-free at scrape time; they are
        # registered here, as in the JAX server, so those reads count as
        # construction (a scrape never takes ``_cond``)
        m = self.metrics
        m.gauge("generation_slots", "decode slot pool size",
                fn=lambda: self.slots)
        m.gauge("generation_active_slots", "slots currently decoding",
                fn=lambda: self._n_active)
        m.gauge("generation_active_slot_cap",
                "autoscaler admission cap on concurrently active slots",
                fn=lambda: self._active_cap)
        m.gauge("generation_queue_depth", "requests waiting for a slot",
                fn=lambda: len(self._queue))
        m.gauge("generation_pending", "admitted-but-unresolved requests",
                fn=lambda: self.admission.pending)
        m.gauge("generation_accepted", "requests accepted by admission",
                fn=lambda: self.admission.accepted)
        m.gauge("generation_rejected", "requests rejected by admission",
                fn=lambda: self.admission.rejected)
        m.gauge("generation_breaker_open",
                "circuit state (0 closed, 0.5 half-open, 1 open)",
                fn=lambda: {"half_open": 0.5, "open": 1.0}.get(
                    self.breaker.state, 0.0))
        m.gauge("generation_pages_free", "unallocated KV pages",
                fn=lambda: len(self._page_pool.free))
        m.gauge("generation_pages_cached", "prefix-cache-pinned KV pages",
                fn=lambda: len(self._page_pool.cache))
        m.gauge("generation_resident_kv_bytes", "bytes of resident KV",
                fn=lambda: self._page_pool.in_use() * self._page_bytes)
        m.gauge("generation_pages_total", "KV page-pool size "
                "(incl. the reserved garbage page)",
                fn=lambda: self.pages_total)
        m.gauge("generation_pages_in_use",
                "pages holding live data (refcounted or prefix-cached)",
                fn=lambda: self._page_pool.in_use())
        m.gauge("generation_pages_shared",
                "pages refcounted by more than one slot",
                fn=lambda: self._page_pool.shared_count())
        m.gauge("generation_peak_resident_kv_bytes",
                "high-water resident KV bytes",
                fn=lambda: self._page_pool.peak * self._page_bytes)
        m.gauge("generation_kv_bytes_per_token",
                "bytes per resident KV token (values + dequant scales)",
                fn=lambda: self._page_token_bytes)
        m.gauge("generation_kv_cache_int8",
                "1 when pages store int8 (+f32 scales), 0 for conf dtype",
                fn=lambda: 1.0 if self.kv_dtype == "int8" else 0.0)

        self._fwd = lm_stream_forward(net)
        self._pool = self._fresh_pool()
        if draft_net is not None:
            self._dfwd = lm_stream_forward(draft_net)
        self._dpool = None if draft_net is None else self._fresh_draft_pool()
        self._runtime = ServingLoop("generation-server",
                                    tick=self._tick_once,
                                    wake=self._wake_loop, chaos=chaos)
        self._runtime.start()
        supervisor().watch(self._runtime, on_death=self._on_loop_death,
                           restart=True)

    @staticmethod
    def _resolve_mesh(mesh, tp):
        """The validated mesh, or None when neither ``mesh`` nor a ``tp``
        other than 1 is given."""
        if mesh is None and tp is not None and int(tp) != 1:
            mesh = model_mesh(int(tp))
        if mesh is None:
            return None
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if MODEL_AXIS not in mesh.axis_names:
            raise MeshGeometryError(
                f"GenerationServer mesh needs a {MODEL_AXIS!r} axis "
                f"to shard KV heads over, got axes {mesh.axis_names}")
        if tp is not None and int(tp) != mesh.shape[MODEL_AXIS]:
            raise MeshGeometryError(
                f"tp={tp} disagrees with the mesh's "
                f"{mesh.shape[MODEL_AXIS]}-way {MODEL_AXIS!r} axis")
        if mesh.size != mesh.shape[MODEL_AXIS]:
            raise MeshGeometryError(
                f"GenerationServer shards heads over a 1-D {MODEL_AXIS!r} "
                f"mesh, got axes {mesh.shape}")
        return mesh

    @property
    def _weights(self):
        """(params, state) on the server's device: the net's own, or their
        replica on the mesh's first device (copied again when the net's
        tensors change)."""
        return self._replicas.weights(self.device)

    def _register_metrics(self, registry):
        """The serving counters, under the JAX server's metric
        names and help strings. Counters live in the (leaf-locked)
        registry, so the loop publishes without touching ``_cond`` and a
        scrape never blocks admission."""
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        m = self.metrics
        self._m_admitted = m.counter(
            "generation_admitted_total", "requests committed to a slot")
        self._m_expired = m.counter(
            "generation_expired_total", "requests failed on deadline")
        self._m_retired = m.counter(
            "generation_retired_total", "slots retired")
        self._m_completed = m.counter(
            "generation_completed_total", "requests completed")
        self._m_failed = m.counter(
            "generation_failed_total", "requests failed on error")
        self._m_retried = m.counter(
            "generation_retried_total", "dispatch retries")
        self._m_pool_rebuilds = m.counter(
            "generation_pool_rebuilds_total",
            "device-state rebuilds after a hard dispatch fault")
        self._m_prefills = m.counter(
            "generation_prefills_total", "prompts prefilled")
        self._m_decode_steps = m.counter(
            "generation_decode_steps_total", "decode dispatches")
        self._m_tokens = m.counter(
            "generation_tokens_total", "tokens generated")
        self._m_busy_s = m.counter(
            "generation_busy_seconds_total",
            "wall seconds spent in prefill/decode dispatches")
        self._m_cow_copies = m.counter(
            "generation_cow_copies_total", "copy-on-write page copies")
        self._m_preempted = m.counter(
            "generation_preempted_total",
            "slots preempted under page-pool pressure")
        self._m_prefix_hits = m.counter(
            "generation_prefix_hits_total",
            "prompts that reused a cached prefix")
        self._m_prefix_reused = m.counter(
            "generation_prefix_tokens_reused_total",
            "prompt tokens served from the prefix cache")
        self._m_spec_rounds = m.counter(
            "generation_spec_rounds_total", "speculative decode rounds")
        self._m_spec_proposed = m.counter(
            "generation_spec_proposed_total", "draft tokens proposed")
        self._m_spec_accepted = m.counter(
            "generation_spec_accepted_total", "draft tokens accepted")
        self._m_handoff_snapshots = m.counter(
            "generation_handoff_snapshots_total",
            "KV snapshots exported (periodic, explicit, and migrate)")
        self._m_handoff_bytes = m.counter(
            "generation_handoff_bytes_total",
            "wire bytes of exported KV snapshots")
        self._m_handoff_resumes = m.counter(
            "generation_handoff_resumes_total",
            "requests resumed from an adopted KV snapshot")
        self._m_handoff_saved = m.counter(
            "generation_handoff_tokens_saved_total",
            "decoded tokens NOT regenerated thanks to snapshot resume")
        self._m_handoff_fallbacks = m.counter(
            "generation_handoff_fallbacks_total",
            "adoptions that fell back to token-0 prefill")
        self._m_preempt_resumes = m.counter(
            "generation_handoff_preempt_resumes_total",
            "preemptions that saved a snapshot instead of recomputing")
        self._m_migrated = m.counter(
            "generation_handoff_migrated_total",
            "requests migrated off this server by drain(migrate=...)")
        self._m_prefill_exports = m.counter(
            "generation_prefill_exports_total",
            "requests exported as KVSnapshots after prefill "
            "(disaggregated prefill tier)")

    # ------------------------------------------------- lifecycle state
    @property
    def _closing(self) -> bool:
        """True once the loop left RUNNING (draining or closed)."""
        return self._runtime.state in (DRAINING, CLOSED)

    @property
    def active_slot_cap(self) -> int:
        """Admission cap on concurrently ACTIVE slots (the autoscaler's
        lever): it bounds how many slots ``_admit_free_slots`` may fill,
        never the pool."""
        with self._cond:
            return self._active_cap

    def set_active_slots(self, n: int) -> int:
        """Clamp and apply a new active-slot cap. Lowering it never evicts
        a running request; it only stops admissions until occupancy falls
        below the cap."""
        n = max(1, min(int(n), self.slots))
        with self._cond:
            self._active_cap = n
            self._cond.notify_all()
        return n

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # ------------------------------------------------------ introspection
    def _probe_net(self):
        """Classify the net's streaming layers: which hold pageable KV, which
        only carry positions; derive the block-table geometry from the KV
        capacity and the bytes one token takes in the pool (the snapshot
        header's ``page_token_bytes``, as the JAX server counts it)."""
        self._paged_names: list = []
        self._pos_names: list = []
        self._layer_by_name: dict = {}
        self._pa_prev: dict = {}
        if self.kv_dtype == "int8":
            kv_itemsize, scale_bytes = 1, 4
        else:
            kv_itemsize = getattr(torch, self.net.conf.dtype).itemsize
            scale_bytes = 0
        self._page_token_bytes = 0
        caps = []
        for name, layer in self.net._stream_layers():
            if isinstance(layer, SelfAttentionLayer) and layer.causal:
                self._layer_by_name[name] = layer
                self._paged_names.append(name)
                caps.append(layer.max_cache)
                h = layer.n_heads
                if h % self._tp:
                    raise MeshGeometryError(
                        f"layer {name!r} has {h} heads, not divisible by "
                        f"tp={self._tp}: the head-parallel pool shard "
                        "[pages, H/tp, page_size, d] would be ragged")
                self._page_token_bytes += 2 * h * (
                    (layer.n_out // h) * kv_itemsize + scale_bytes)
                if self.paged_attention is not None:
                    self._pa_prev[name] = layer.paged_attention
                    layer.paged_attention = self.paged_attention
            elif isinstance(layer, PositionalEncodingLayer):
                self._pos_names.append(name)
        if not self._paged_names:
            raise ValueError(
                "net has no causal attention layer to page — "
                "GenerationServer serves KV-cache language models "
                "(TransformerLM)")
        cap = min(caps)
        if cap % self._ps:
            raise ValueError(
                f"page_size {self._ps} must divide the KV-cache capacity "
                f"{cap} (attention max_cache)")
        self._cap_tokens = cap
        self._np = cap // self._ps

    def _probe_draft(self):
        """Classify the draft's streaming layers (dense KV caches and
        position counters) and check that it reaches every position the
        target can."""
        draft = self._draft
        if draft.device != self.device:
            raise ValueError(f"draft_net lives on {draft.device}, the "
                             f"server on {self.device}")
        self._d_attn_names: list = []
        self._d_pos_names: list = []
        caps = []
        for name, layer in draft._stream_layers():
            if isinstance(layer, SelfAttentionLayer) and layer.causal:
                self._d_attn_names.append(name)
                caps.append(layer.max_cache)
            elif isinstance(layer, PositionalEncodingLayer):
                self._d_pos_names.append(name)
        if not self._d_attn_names:
            raise ValueError("draft_net has no causal attention layer — "
                             "speculative decoding needs a KV-cache "
                             "streaming draft model")
        self._draft_cap = min(caps)
        if self._draft_cap < self._cap_tokens:
            raise ValueError(
                f"draft_net max_cache {self._draft_cap} < target capacity "
                f"{self._cap_tokens}: the draft must reach every "
                "position the target can")

    def _fresh_pool(self):
        """One pool per paged layer, each leaf the list of its head shards,
        shard i on the i-th shard device (one shard without a mesh)."""
        dtype = getattr(torch, self.net.conf.dtype)
        pool = {}
        for name in self._paged_names:
            layer = self._layer_by_name[name]
            shards = [layer.init_paged_carry(
                self.pages_total, self._ps, dtype, kv_dtype=self.kv_dtype,
                device=dev, heads=layer.n_heads // self._tp)
                for dev in self._shard_devices]
            pool[name] = {k: [sh[k] for sh in shards] for k in shards[0]}
        # the admission ledger's bytes per page must be the bytes the pool
        # really holds
        nbytes = sum(a.numel() * a.element_size()
                     for leaves in pool.values()
                     for leaf in leaves.values() for a in leaf)
        if nbytes != self._page_bytes * self.pages_total:
            raise AssertionError(
                f"KV admission accounting diverged from the allocated "
                f"pool: {self._page_bytes} bytes/page expected, "
                f"{nbytes // self.pages_total} allocated")
        return pool

    def _fresh_draft_pool(self):
        """Dense ``[S, H, cap, d]`` slot caches for the draft model (the
        draft is small: paging it would buy little and cost a second block
        table)."""
        dtype = getattr(torch, self._draft.conf.dtype)
        layers = dict(self._draft._stream_layers())
        return {vn: {k: v for k, v in layers[vn].init_streaming_carry(
            self.slots, dtype, device=self.device).items()
            if k != "cache_pos"} for vn in self._d_attn_names}

    def _dcarry(self, pos):
        """The draft's carry: its dense caches (updated in place) and the
        ``[S]`` per-row positions for every streaming layer."""
        carry = {vn: {"cache_pos": pos} for vn in self._d_pos_names}
        for vn in self._d_attn_names:
            carry[vn] = dict(self._dpool[vn], cache_pos=pos)
        return carry

    def _carry(self, bt, pos):
        """The forward's serving carry: the pools (updated in place), one
        block table and per-row positions for every streaming layer."""
        carry = {vn: {"cache_pos": pos} for vn in self._pos_names}
        for vn in self._paged_names:
            carry[vn] = dict(self._pool[vn], block_table=bt, cache_pos=pos)
        return carry

    def _to_dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- submit
    def _check_fits(self, plen: int, max_tokens: int, what: str,
                    margin: int = 0):
        """Page-budget feasibility, up front: prompt + generated positions
        (+ ``margin``, the look-ahead a speculative verify chunk writes)
        must fit the block table and the pool less the garbage page."""
        need_tokens = plen + int(max_tokens) + margin - 1
        if need_tokens > self._cap_tokens:
            raise ServerOverloaded(
                f"infeasible {what}: prompt {plen} + max_tokens "
                f"{max_tokens} (+{margin} look-ahead) exceeds the per-slot "
                f"KV capacity {self._cap_tokens} ({self._np} pages x "
                f"{self._ps})")
        need_pages = -(-need_tokens // self._ps)
        if need_pages > self.pages_total - 1:
            raise ServerOverloaded(
                f"infeasible {what}: needs {need_pages} pages but the "
                f"pool capacity is {self.pages_total - 1} usable pages "
                f"of {self._ps} tokens")

    def _check_breaker(self):
        if not self.breaker.allow():
            raise CircuitOpen("circuit breaker is open: recent decode "
                              "dispatches failed above threshold")

    def _enqueue(self, req: _Request) -> Future:
        # export_request clamps its wait to the request's own budget
        req.future._deadline = req.deadline
        self.admission.acquire()  # raises ServerOverloaded at watermark
        req.future.add_done_callback(lambda _f: self.admission.release())
        with self._cond:
            if self._closing:
                # lost the race with close(): fail typed, not hung
                self._fail(req, RuntimeError("GenerationServer is closed"))
                return req.future
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    def submit(self, prompt_ids, max_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               eos_id=_UNSET, deadline_s: Optional[float] = None,
               export_kv: Optional[bool] = None) -> Future:
        """Queue one generation request; returns a Future resolving to the
        generated ids (<= max_tokens, shorter when ``eos_id`` — the
        per-request one or the server default — is produced, which is
        included). ``temperature`` 0 is greedy; otherwise tokens are
        sampled from the softmax sharpened by 1/temperature, among the
        ``top_k`` most likely when ``top_k > 0``, with token i keyed by
        ``fold_in(PRNGKey(seed), i)``. ``deadline_s`` (default: the
        server's ``request_deadline_s``) bounds the request's time: past it
        the future fails ``DeadlineExceeded``. Raises ``ServerOverloaded``
        when the request can never fit the page budget or the admission
        watermark is reached, and ``CircuitOpen`` while dispatches are
        failing.

        ``export_kv`` True resolves the future to a ``KVSnapshot`` right
        after prefill (first token included) for a decode-role server to
        adopt; False decodes to completion here; None follows the server's
        ``role`` (True on a prefill-role server)."""
        prompt = np.asarray(prompt_ids)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(f"prompt_ids must be a non-empty 1-D id "
                             f"array, got shape {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer) or \
                prompt.min() < 0 or prompt.max() >= self.vocab:
            raise ValueError(f"prompt_ids must be integer ids in [0, "
                             f"{self.vocab})")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0 or top_k > self.vocab:
            raise ValueError(f"top_k must be in [0, {self.vocab}], "
                             f"got {top_k}")
        self._check_fits(int(prompt.shape[0]), max_tokens, "request",
                         self.spec_k - 1 if self._draft is not None else 0)
        with self._cond:
            if self._closing:
                raise RuntimeError("GenerationServer is closed")
        self._check_breaker()
        budget = deadline_s if deadline_s is not None \
            else self.request_deadline_s
        req = _Request(prompt.astype(np.int64), int(max_tokens),
                       float(temperature), int(top_k), int(seed),
                       self.eos_id if eos_id is _UNSET else eos_id,
                       None if budget is None else Deadline(budget))
        req.export_kv = (self.role == "prefill") if export_kv is None \
            else bool(export_kv)
        if req.export_kv and self._draft is not None:
            raise SnapshotUnsupported(
                "speculative servers cannot export: the draft's dense "
                "KV cache is not part of the KVSnapshot wire format")
        random.seed_words(req.seed)     # an out-of-range seed fails here
        return self._enqueue(req)

    # ---------------------------------------------------------- the loop
    def _wake_loop(self):
        """Runtime wake hook: nudge a tick blocked on ``_cond``."""
        with self._cond:
            self._cond.notify_all()

    @torch.inference_mode()
    def _tick_once(self) -> bool:
        """One scheduling round of the ``ServingLoop`` tick thread: a
        migrate-out sweep when ``drain(migrate=...)`` asked for one, admit
        and prefill a wave, one decode dispatch (a speculative round with a
        draft), then deadlines, exports and periodic snapshots between
        dispatches. Returns False only on a clean stop."""
        with self._cond:
            if self._runtime.state is CLOSED:
                return False
            migrating = self._migrating
            if (not self._queue and self._n_active == 0
                    and not self._export_q and not migrating):
                self._cond.wait(timeout=0.5)
                return True
        try:
            if migrating:
                if self._chaos is not None:
                    # a migrate-out sweep is a drain phase: kill_during_drain
                    # chaos attacks it too, and its LoopKilled (a
                    # BaseException) escapes the except below into the
                    # supervisor
                    self._chaos.drain_fault()
                self._migrate_out()
            self._admit_free_slots()
            with self._cond:
                n_active = self._n_active
            if n_active:
                t0 = time.monotonic()
                if self._draft is not None:
                    self._spec_decode_once()
                else:
                    self._decode_once()
                self._m_busy_s.inc(time.monotonic() - t0)
            self._expire_active()
            # explicit exports first (a caller is blocked on them), then at
            # most one periodic snapshot per round
            self._service_exports()
            self._maybe_snapshot_slots()
        except Exception as e:  # noqa: BLE001 — a loop death would hang
            # every outstanding future; fail them typed instead
            self._fail_all(e)
        return True

    def _on_loop_death(self, loop, exc) -> bool:
        """Supervisor recovery hook: the tick thread died (a chaos kill, or
        a fault that escaped ``_fail_all``). Fail every in-flight future and
        pending export typed, release the dead slots' pages and, unless the
        server was deliberately closed, rebuild the device state so the
        restarted loop serves cleanly. Returns whether to restart."""
        err = LoopCrashed("generation-server loop died with the request "
                          f"in flight: {exc!r}")
        with self._cond:
            stragglers = [s for s in range(self.slots)
                          if self._slot_req[s] is not None]
            victims = [self._slot_req[s] for s in stragglers]
            victims += list(self._queue)
            self._queue.clear()
            self._slot_req = [None] * self.slots
            self._n_active = 0
            exports = list(self._export_q)
            self._export_q.clear()
            # a kill mid-migration resolved every live future (below), so
            # the migration is over: a latched flag would send the
            # restarted tick into the drain path forever
            self._migrating = False
            self._migrate_cb = None
            again = not self._user_close
            self._cond.notify_all()
        self._m_failed.inc(len(victims))
        for req in victims:
            self._fail(req, err)
        for _fut, out in exports:  # never leave an exporter hung
            self._fail_export(out, SnapshotUnavailable(
                "generation loop died before the export was serviced"))
        for s in stragglers:  # the tick thread is dead: safe to touch pages
            self._release_slot_pages(s)
        if again:
            self._m_pool_rebuilds.inc()
            self._reset_device_state()
        return again

    def _pop_admittable(self):
        """The next queued request still worth prefilling (expired ones
        fail typed on the way)."""
        while True:
            with self._cond:
                if not self._queue:
                    return None
                req = self._queue.popleft()
            if req.deadline is not None and req.deadline.expired():
                self._m_expired.inc()
                self._fail(req, DeadlineExceeded(
                    "request budget exhausted while queued "
                    f"({-req.deadline.remaining() * 1e3:.1f} ms over)"))
                continue
            return req

    def _admit_free_slots(self):
        """Admit every queued request a free slot, the active-slot cap and
        the page pool can take (adopting snapshots, sharing resident
        prefixes), then prefill the whole wave together."""
        staged = []                                 # (slot, req, pos0, plen)
        with self._cond:
            budget = self._active_cap - self._n_active
        for s in range(self.slots):
            if len(staged) >= budget:
                break
            if self._slot_req[s] is not None:
                continue
            req = self._pop_admittable()
            if req is None:
                break
            if req.snapshot is not None and self._adopt_into_slot(s, req):
                continue
            # no snapshot (or adoption fell back): token-0 prefill
            plen = req.prompt.shape[0]
            try:
                pos0 = self._stage_prompt_pages(s, req.prompt, plen)
            except RuntimeError as e:  # pool exhausted during staging
                self._release_slot_pages(s)
                if staged:
                    # their completions free the pages this one needs
                    with self._cond:
                        self._queue.appendleft(req)
                    break
                self._m_failed.inc()
                self._fail(req, e)
                continue
            staged.append((s, req, pos0, plen))
        if staged:
            t0 = time.monotonic()
            self._prefill_wave(staged)
            self._m_busy_s.inc(time.monotonic() - t0)

    # -------------------------------------------------- page bookkeeping
    def _release_slot_pages(self, slot: int):
        sp = self._slot_pages[slot]
        for page in sp:
            self._page_pool.release(page)
        sp.clear()
        self._bt[slot, :] = GARBAGE_PAGE
        self._pos[slot] = 0

    def _pick_victim(self, keep_slot: int):
        """The most recently admitted resident slot other than
        ``keep_slot`` (None when there is none)."""
        best, best_seq = None, -1
        for s in range(self.slots):
            if s == keep_slot or self._slot_req[s] is None:
                continue
            if self._slot_seq[s] > best_seq:
                best, best_seq = s, self._slot_seq[s]
        return best

    def _preempt(self, slot: int):
        """Free a slot's pages under pool pressure; its request goes back
        to the FRONT of the queue. A victim with at least a page of decoded
        tokens snapshots before its pages are freed and resumes by
        adoption at position N; otherwise it recomputes from token 0."""
        req = self._slot_req[slot]
        # a speculative server's draft cache cannot ride in a snapshot:
        # its victims recompute
        if (req.snapshot is None and self._draft is None
                and len(req.tokens) >= self._ps):
            try:
                req.snapshot = self._snapshot_slot(slot)
                self._m_preempt_resumes.inc()
            except Exception:  # noqa: BLE001 — best effort: a failed
                # snapshot degrades to the recompute, never fails the
                # request
                req.snapshot = None
        if req.snapshot is None:
            req.tokens.clear()
        self._release_slot_pages(slot)
        self._m_preempted.inc()
        with self._cond:
            self._slot_req[slot] = None
            self._n_active -= 1
            self._queue.appendleft(req)
            self._cond.notify_all()

    def _alloc_page(self, for_slot: int) -> int:
        """One fresh page, evicting cached pages and then preempting the
        newest other slot while the pool is dry."""
        while True:
            page = self._page_pool.alloc()
            if page is not None:
                return page
            victim = self._pick_victim(for_slot)
            if victim is None:
                raise RuntimeError(
                    "page pool exhausted with nothing left to preempt — "
                    "admission should have rejected this request")
            self._preempt(victim)

    def _copy_page(self, src: int, dst: int):
        """Pool page ``src`` into page ``dst`` in every layer, every leaf
        (K/V pages and the int8 scale planes)."""
        for vn in self._paged_names:
            for leaf in self._pool[vn].values():
                for a in leaf:
                    a[dst] = a[src]

    def _ensure_writable(self, slot: int, idx: int):
        """Copy-on-write: the slot is about to write into its idx-th logical
        page; if that page is shared (or kept pristine by the prefix cache)
        copy it off and repoint the block table."""
        sp = self._slot_pages[slot]
        page = sp[idx]
        if not self._page_pool.protected(page):
            return
        dst = self._alloc_page(slot)
        self._copy_page(page, dst)
        self._m_cow_copies.inc()
        self._page_pool.release(page)
        sp[idx] = dst
        self._bt[slot, idx] = dst

    def _ensure_slot_pages(self, slot: int, upto: int, write_from: int):
        """Slot ``slot`` is about to write positions ``[write_from,
        upto)``: allocate any missing pages and copy the shared ones in the
        write range."""
        sp = self._slot_pages[slot]
        n = -(-upto // self._ps)
        if n > self._np:
            raise RuntimeError(
                f"slot {slot} needs {n} pages > block table width "
                f"{self._np} — admission should have rejected this")
        while len(sp) < n:
            page = self._alloc_page(slot)
            self._bt[slot, len(sp)] = page
            sp.append(page)
        for idx in range(write_from // self._ps,
                         (upto - 1) // self._ps + 1):
            self._ensure_writable(slot, idx)

    def _reserve_decode_pages(self):
        """Pages for one decode dispatch: every active slot gets pages
        covering its next ``lookahead`` writes (``steps_per_dispatch``, or
        ``spec_k`` for a speculative round; allocation and copy-on-write),
        up to the per-slot capacity (the dispatch write-clamps there),
        preempting the newest slots under pressure."""
        for s in range(self.slots):
            if self._slot_req[s] is None:
                continue
            pos = int(self._pos[s])
            upto = min(pos + self._lookahead, self._cap_tokens)
            if upto > pos:
                self._ensure_slot_pages(s, upto, write_from=pos)

    def _chunk_digests(self, prompt, n: int):
        """The chained SHA-1 digests of the prompt's first ``n`` full
        page-size chunks, in order: each one keys its chunk and every
        token before it."""
        ps = self._ps
        digest = b""
        for i in range(n):
            digest = hashlib.sha1(
                digest + prompt[i * ps:(i + 1) * ps].tobytes()).digest()
            yield digest

    @staticmethod
    def _tail_digest(digest: bytes, rem) -> bytes:
        return hashlib.sha1(digest + b"T" + rem.tobytes()).digest()

    def _match_prefix(self, prompt, plen: int):
        """Longest shared prefix already resident: full page-aligned chunks
        under the chained digest, then the exact whole-prompt tail. Returns
        (shared page list, matched token count) with the shares already
        refcounted; at least one suffix token is always left to prefill
        (the first token needs a true position)."""
        if not self.prefix_cache:
            return [], 0
        pool = self._page_pool
        ps = self._ps
        digest = b""
        pages: list = []
        matched = 0
        full = plen // ps
        for digest in self._chunk_digests(prompt, full):
            page = pool.lookup(digest)
            if page is None:
                break
            pages.append(page)
            matched += ps
        else:
            rem = prompt[full * ps:]
            if rem.size:
                page = pool.lookup(self._tail_digest(digest, rem))
                if page is not None:
                    pages.append(page)
                    matched = plen
        if matched >= plen:
            # whole prompt resident: its last token is prefilled again into
            # the shared page, which copies off the slot's own page
            matched = plen - 1
        for page in pages:
            pool.share(page)
        return pages, matched

    def _stage_prompt_pages(self, slot: int, prompt, plen: int) -> int:
        """Assemble the slot's block-table row for prefill: the shared
        prefix pages, then private pages for the suffix tokens only (bucket
        padding writes the garbage page). Returns the suffix offset."""
        shared, matched = self._match_prefix(prompt, plen)
        sp = self._slot_pages[slot]
        sp.extend(shared)
        for i, page in enumerate(shared):
            self._bt[slot, i] = page
        if matched:
            self._m_prefix_hits.inc()
            self._m_prefix_reused.inc(matched)
        self._ensure_slot_pages(slot, plen, write_from=matched)
        return matched

    def _trim_slot_pages(self, slot: int, plen: int):
        """Drop pages wholly beyond the next write position."""
        sp = self._slot_pages[slot]
        keep = plen // self._ps + 1
        while len(sp) > keep:
            page = sp.pop()
            self._bt[slot, len(sp)] = GARBAGE_PAGE
            self._page_pool.release(page)

    def _register_prefix(self, slot: int, prompt, plen: int):
        """Publish the slot's prompt pages in the prefix cache: full chunks
        under the chained digest, plus the whole-prompt partial tail. The
        registered pages become copy-protected, so the first divergent
        write (this slot's own next decode token included) copies off a
        private page and the cached original stays pristine."""
        if not self.prefix_cache:
            return
        sp = self._slot_pages[slot]
        pool = self._page_pool
        ps = self._ps
        digest = b""
        full = plen // ps
        for i, digest in enumerate(self._chunk_digests(prompt, full)):
            pool.register(digest, sp[i])
        rem = prompt[full * ps:]
        if rem.size and full < len(sp):
            pool.register(self._tail_digest(digest, rem), sp[full])

    # ------------------------------------------------ guarded dispatch
    def _guarded(self, fn, deadline=None):
        """Run one dispatch ``fn()`` under the chaos injector (when one is
        given), the breaker's per-attempt accounting and the retry policy
        (transient faults are retried until the attempt budget or
        ``deadline`` runs out). ``fn`` reads host state and writes only
        the pools, each attempt the same values at the same slots, so a
        retry after a fault that struck mid-forward yields the same
        tokens."""
        dispatch = fn if self._chaos is None else self._chaos.wrap(fn)

        def attempt():
            try:
                out = dispatch()
            except Exception:
                self.breaker.record_failure()
                raise
            self.breaker.record_success()
            return out

        return self.retry.call(attempt, deadline=deadline,
                               on_retry=self._count_retry)

    def _count_retry(self, attempt, exc):
        self._m_retried.inc()

    # ------------------------------------------------------ prefill path
    def _prefill_wave(self, group):
        """Batched chunked prefill for one admission wave: every staged
        slot advances from its shared-prefix offset through rounds of at
        most ``prefill_chunk`` tokens, ONE paged forward per round for the
        rows with suffix left. A row takes its first token in the round
        that consumes its final chunk. A round that fails (its retries
        spent) fails the wave's requests typed and frees their slots. A
        speculative server then primes each slot's draft cache; the
        wave's ``export_kv`` requests leave as snapshots."""
        S = self.slots
        cur = {s: pos0 for s, _, pos0, _ in group}
        first = {}
        keys = np.zeros((S, 2), np.int64)
        deadline = None              # the wave retries within its tightest
        for s, req, _, _ in group:
            keys[s] = random.seed_words(req.seed)
            if req.deadline is not None and (
                    deadline is None or req.deadline.remaining()
                    < deadline.remaining()):
                deadline = req.deadline
        cap_pages = max(1, self._chunk_cap // self._ps)
        while True:
            live = [(s, req, plen) for s, req, _, plen in group
                    if cur[s] < plen]
            if not live:
                break
            chunk = {s: min(plen - cur[s], self._chunk_cap)
                     for s, _, plen in live}
            target = max(max(chunk.values()), self.min_prefill_bucket)
            bucket = bucket_pages(target, self._ps,
                                  maximum=min(self._np, cap_pages)) * self._ps
            ids = np.zeros((S, bucket), np.int64)
            mask = np.zeros((S, bucket), np.float32)
            admit = np.zeros((S,), bool)
            positions = np.zeros((S,), np.int32)
            sufflen = np.ones((S,), np.int64)
            temp = np.zeros((S,), np.float32)
            topk = np.zeros((S,), np.int64)
            for s, req, _ in live:
                n = chunk[s]
                ids[s, :n] = req.prompt[cur[s]:cur[s] + n]
                mask[s, :n] = 1
                admit[s] = True
                positions[s] = cur[s]
                sufflen[s] = n
                temp[s] = req.temperature
                topk[s] = req.top_k
            try:
                toks = self._guarded(
                    lambda: self._prefill_round(ids, mask, admit, positions,
                                                sufflen, temp, topk, keys),
                    deadline)
            except Exception as e:  # noqa: BLE001 — typed failure for the
                # wave; every staged slot stays free for the next one
                for s, req, *_ in group:
                    self._release_slot_pages(s)
                    self._count_failure(e)
                    self._fail(req, e)
                return
            self._prefill_rounds += 1
            for s, _, plen in live:
                cur[s] += chunk[s]
                if cur[s] >= plen:
                    first[s] = toks[s]
        for s, req, _, plen in group:
            if self._draft is not None:
                try:
                    self._draft_prefill(s, req)
                except Exception as e:  # noqa: BLE001 — typed, this slot
                    self._release_slot_pages(s)
                    self._count_failure(e)
                    self._fail(req, e)
                    continue
            self._commit_slot(s, req, plen, first[s], keys[s])
        # disaggregated prefill: export the wave's export_kv slots still
        # live (one that finished on its first token already retired with
        # its tokens)
        exports = [(s, req) for s, req, *_ in group
                   if req.export_kv and self._slot_req[s] is req]
        if exports:
            self._transfer_loop(exports)

    def _count_failure(self, exc: BaseException):
        if isinstance(exc, DeadlineExceeded):
            self._m_expired.inc()
        else:
            self._m_failed.inc()

    def _sampling(self, temp, topk, keys):
        """The per-row sampling values on the device, or None when every
        row is greedy (host arrays ``[S]``, ``[S]``, ``[S, 2]``)."""
        if not (temp > 0).any():
            return None
        return self._to_dev(temp), self._to_dev(topk), self._to_dev(keys)

    @staticmethod
    def _select(probs, sampling, counts):
        """Each row's next token from its ``[S, V]`` probabilities: the
        argmax when every row is greedy (``sampling`` None), else
        ``sampled_next_token`` with row s keyed by ``fold_in(keys[s],
        counts[s])``."""
        if sampling is None:
            return probs.argmax(dim=-1)
        temp, topk, keys = sampling
        return sampled_next_token(probs, random.fold_in(keys, counts), temp,
                                  topk)

    def _prefill_round(self, ids, mask, admit, positions, sufflen, temp,
                       topk, keys):
        """One paged forward over the wave's chunk; returns each row's
        first token, selected at its last true position with key
        ``fold_in(keys[s], 0)`` (ONE host copy)."""
        dtype = getattr(torch, self.net.conf.dtype)
        bt = self._to_dev(self._bt)
        # rows not in this round write the garbage page: an active decode
        # slot riding along must not have its real pages clobbered
        bt_eff = torch.where(self._to_dev(admit)[:, None], bt,
                             torch.zeros_like(bt))
        mask_t = self._to_dev(mask)
        x = F.one_hot(self._to_dev(ids), self.vocab).to(dtype) \
            * mask_t[..., None].to(dtype)
        carry = self._carry(bt_eff, self._to_dev(positions))
        out, _ = self._fwd(*self._weights, x, carry, mask_t)
        rows = out[torch.arange(self.slots, device=self.device),
                   self._to_dev(sufflen) - 1]
        sampling = self._sampling(temp, topk, keys)
        first = None if sampling is None else torch.zeros(
            self.slots, dtype=torch.int64, device=self.device)
        return self._select(rows, sampling, first).cpu().tolist()

    def _draft_prefill(self, slot: int, req: _Request):
        """Prime the draft's dense cache row for ``slot`` with the whole
        prompt (the dense draft cache shares no pages): the row is zeroed
        and the prompt streamed through it from position 0."""
        dtype = getattr(torch, self._draft.conf.dtype)
        x = F.one_hot(self._to_dev(req.prompt[None]), self.vocab).to(dtype)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)

        def run():
            carry = {vn: {"cache_pos": zero} for vn in self._d_pos_names}
            for vn in self._d_attn_names:
                row = {k: a[slot:slot + 1]
                       for k, a in self._dpool[vn].items()}
                for a in row.values():
                    a.zero_()
                carry[vn] = dict(row, cache_pos=zero)
            self._dfwd(self._draft.params, self._draft.state, x, carry)

        self._guarded(run, req.deadline)

    def _activate(self, slot: int, req: _Request):
        """Mark a seeded slot resident: the newest admission (the first
        preemption victim)."""
        self._admit_seq += 1
        self._slot_seq[slot] = self._admit_seq
        with self._cond:
            self._slot_req[slot] = req
            self._n_active += 1
        self._m_admitted.inc()

    def _commit_slot(self, slot: int, req: _Request, plen: int, tok, key):
        """Publish one prefilled slot: trim the bucket over-allocation,
        register its prefix pages, seed the decode mirrors (its next token
        is token 1 of its key schedule), and mark the slot active."""
        self._trim_slot_pages(slot, plen)
        self._register_prefix(slot, req.prompt, plen)
        self._last[slot] = tok
        self._pos[slot] = plen
        self._counts[slot] = 1
        self._snap_counts[slot] = 0
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._keys[slot] = key
        req.tokens.append(tok)
        # TTFT stamp: the first token exists now, even when the request
        # later crosses the tier boundary (the fleet's histograms read it)
        req.future._t_first = time.monotonic()
        self._activate(slot, req)
        self._m_prefills.inc()
        self._m_tokens.inc()
        if self._finished(req, tok):
            self._retire(slot, req)

    # ------------------------------------------------------- decode path
    def _active_mask(self):
        return np.array([r is not None for r in self._slot_req])

    def _dispatch_inputs(self, active):
        """A decode dispatch's inputs uploaded from the host mirrors:
        positions, last tokens, the ``[S]`` active mask, the active rows'
        sampling values (others zeroed; None when all are greedy) and, when
        sampling, the per-row key counts."""
        sampling = self._sampling(
            np.where(active, self._temp, 0).astype(np.float32), self._topk,
            self._keys)
        counts = None if sampling is None else self._to_dev(self._counts)
        return (self._to_dev(self._pos), self._to_dev(self._last),
                self._to_dev(active), sampling, counts)

    def _paged_step(self, active):
        """``steps_per_dispatch`` micro-steps over all S rows, each one
        paged forward and one token select, from the host mirrors (the
        active slots' sampling values, others zeroed). Returns the
        ``[S, M]`` tokens on the host (ONE copy)."""
        dtype = getattr(torch, self.net.conf.dtype)
        bt = self._to_dev(self._bt)
        cap = bt.shape[1] * self._ps
        pos, cur, act_t, sampling, cnt = self._dispatch_inputs(active)
        seq = []
        for _ in range(self.steps_per_dispatch):
            # write-clamp: rows at capacity freeze, and their WHOLE
            # block-table row swaps to the garbage page so the clamped
            # column write lands there instead of on real KV at cap-1
            act = act_t & (pos < cap)
            posw = torch.clamp(pos, max=cap - 1)
            bt_eff = torch.where(act[:, None], bt, torch.zeros_like(bt))
            x = F.one_hot(cur, self.vocab).to(dtype)[:, None, :]
            out, _ = self._fwd(*self._weights, x,
                               self._carry(bt_eff, posw))
            nxt = self._select(out[:, 0], sampling, cnt)
            cur = torch.where(act, nxt, cur)
            pos = torch.where(act, pos + 1, pos)
            if cnt is not None:
                cnt = torch.where(act, cnt + 1, cnt)
            seq.append(cur)
        return torch.stack(seq, dim=1).cpu().numpy()

    def _decode_once(self):
        self._reserve_decode_pages()
        active = self._active_mask()
        if not active.any():          # every slot preempted by the reserve
            return
        try:
            toks = self._guarded(lambda: self._paged_step(active))
        except Exception as e:  # noqa: BLE001 — the pool is suspect: fail
            # the batch typed and serve later requests from a fresh pool
            self._fail_all(e)
            return
        m_steps = self.steps_per_dispatch
        ntok = 0
        done = []
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            for tok in toks[s].tolist():
                req.tokens.append(tok)
                ntok += 1
                if self._finished(req, tok):
                    done.append((s, req))
                    break
            # the device advanced the full window (write-clamped at the
            # capacity) regardless of where the request finished
            adv = min(m_steps, self._cap_tokens - self._pos[s])
            self._pos[s] += adv
            self._counts[s] += adv
            self._last[s] = toks[s, m_steps - 1]
        self._m_decode_steps.inc()
        self._m_tokens.inc(ntok)
        # resolve after publishing: a caller woken by its result reads
        # counters that include the dispatch that finished it
        for s, req in done:
            self._retire(s, req)

    def _spec_step(self, active):
        """One speculative round from the host mirrors: the draft proposes
        ``spec_k - 1`` tokens over its dense cache (per-row positions, the
        serial key schedule), the last proposal is fed too (a full accept
        then leaves the draft cache hole-free), and the target verifies
        ``[last, drafts]`` in ONE chunked paged forward. Returns the
        target's ``[S, K]`` selections and, in a last column, each row's
        count of leading draft matches (ONE host copy)."""
        K = self.spec_k
        dtype = getattr(torch, self.net.conf.dtype)
        ddtype = getattr(torch, self._draft.conf.dtype)
        positions, last, act, sampling, counts = self._dispatch_inputs(active)
        dparams, dstate = self._draft.params, self._draft.state
        pos, cur, cnt = positions, last, counts
        props = []
        for _ in range(K - 1):
            x = F.one_hot(cur, self.vocab).to(ddtype)[:, None, :]
            out, _ = self._dfwd(dparams, dstate, x, self._dcarry(pos))
            cur = torch.where(act, self._select(out[:, 0], sampling, cnt),
                              cur)
            pos = torch.where(act, pos + 1, pos)
            if cnt is not None:
                cnt = torch.where(act, cnt + 1, cnt)
            props.append(cur)
        x = F.one_hot(cur, self.vocab).to(ddtype)[:, None, :]
        self._dfwd(dparams, dstate, x, self._dcarry(pos))
        drafts = torch.stack(props, dim=1)                       # [S, K-1]
        x = F.one_hot(torch.cat([last[:, None], drafts], dim=1),
                      self.vocab).to(dtype)                      # [S, K, V]
        out, _ = self._fwd(*self._weights, x,
                           self._carry(self._to_dev(self._bt), positions))
        if sampling is None:
            true = out.argmax(dim=-1)
        else:
            true = spec_verify_tokens(out, sampling[2], counts, sampling[0],
                                      sampling[1])
        acc = (drafts == true[:, :K - 1]).long().cumprod(dim=1).sum(dim=1)
        return torch.cat([true, acc[:, None]], dim=1).cpu().numpy()

    def _spec_decode_once(self):
        self._reserve_decode_pages()
        active = self._active_mask()
        if not active.any():          # every slot preempted by the reserve
            return
        k_spec = self.spec_k
        # the draft writes positions [pos, pos + K) of its dense cache;
        # admission's look-ahead margin keeps them inside, checked here on
        # the host mirrors (the forward never syncs on positions)
        if (self._pos[active] + k_spec > self._draft_cap).any():
            raise RuntimeError("a speculative round would run past the "
                               "draft's KV capacity — admission should "
                               "have rejected this request")
        try:
            res = self._guarded(lambda: self._spec_step(active))
        except Exception as e:  # noqa: BLE001 — both pools are suspect
            self._fail_all(e)
            return
        true, acc = res[:, :k_spec], res[:, k_spec]
        ntok = proposed = accepted = 0
        done = []
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            n = min(acc[s] + 1, k_spec)
            proposed += k_spec - 1
            accepted += n - 1
            for tok in true[s, :n].tolist():
                req.tokens.append(tok)
                ntok += 1
                if self._finished(req, tok):
                    done.append((s, req))
                    break
            self._counts[s] += n
            self._pos[s] += n
            self._last[s] = true[s, n - 1]
        self._m_spec_rounds.inc()
        self._m_spec_proposed.inc(proposed)
        self._m_spec_accepted.inc(accepted)
        self._m_decode_steps.inc()
        self._m_tokens.inc(ntok)
        for s, req in done:
            self._retire(s, req)

    def _finished(self, req: _Request, tok) -> bool:
        if req.eos_id is not None and tok == req.eos_id:
            return True
        return len(req.tokens) >= req.max_tokens

    def _vacate(self, slot: int):
        """Free a slot's pages and mark it empty."""
        self._release_slot_pages(slot)
        with self._cond:
            self._slot_req[slot] = None
            self._n_active -= 1
            self._cond.notify_all()

    def _retire(self, slot: int, req: _Request):
        self._vacate(slot)
        self._m_retired.inc()
        self._m_completed.inc()
        try:
            req.future.set_result(np.asarray(req.tokens, np.int64))
        except Exception:  # future cancelled by the caller
            pass

    def _expire_active(self):
        """Fail every resident request whose deadline has passed."""
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None or req.deadline is None \
                    or not req.deadline.expired():
                continue
            self._vacate(s)
            self._m_expired.inc()
            self._fail(req, DeadlineExceeded(
                "request budget exhausted mid-generation after "
                f"{len(req.tokens)} tokens"))

    def _fail(self, req: _Request, exc: BaseException):
        try:
            req.future.set_exception(exc)
        except Exception:  # already resolved/cancelled
            pass

    def _fail_all(self, exc: BaseException):
        """Hard dispatch fault: every in-flight request fails typed (never
        hangs) and the device state is rebuilt from zeros. The rebuild
        decision is taken under ``_cond``, so a fault racing ``close()``
        never resurrects device state on a server shutting down."""
        with self._cond:
            victims = [r for r in self._slot_req if r is not None]
            victims += list(self._queue)
            self._queue.clear()
            self._slot_req = [None] * self.slots
            self._n_active = 0
            rebuild = not self._closing
            self._cond.notify_all()
        self._m_failed.inc(len(victims))
        if rebuild:
            self._m_pool_rebuilds.inc()
        for req in victims:
            self._fail(req, exc)
        if rebuild:
            self._reset_device_state()

    def _reset_device_state(self):
        self._page_pool = _PagePool(self.pages_total)
        self._bt[:] = GARBAGE_PAGE
        self._pos[:] = 0
        self._slot_pages = [[] for _ in range(self.slots)]
        self._pool = self._fresh_pool()
        if self._draft is not None:
            self._dpool = self._fresh_draft_pool()

    # ------------------------------------------------- snapshot/handoff
    def _snapshot_slot(self, slot: int) -> KVSnapshot:
        """Slot ``slot``'s live state as a KVSnapshot: the pages holding KV
        positions [0, pos) in ONE gather per pool leaf and one copy to the
        host, the prefix-cache digests of still-pristine pages, and the
        resume header from the host mirrors. Pages beyond the stream
        position hold look-ahead garbage and are skipped. The mirrors'
        numpy scalars go to ``pack_snapshot`` as they are: the host casts
        happen there, outside the loop's hot-named functions."""
        req = self._slot_req[slot]
        pos = self._pos[slot]
        n = -(-pos // self._ps)            # pages holding [0, pos)
        sp = self._slot_pages[slot]
        digests = [self._page_pool.tag.get(p) for p in sp[:n]]
        idx = torch.tensor(sp[:n], dtype=torch.long)

        def canonical(leaf):
            # head shards gathered back into the [n, H, ...] host layout
            return _to_wire(all_gather(
                [a.index_select(0, idx.to(a.device)) for a in leaf],
                "cpu", dim=1))

        fetched = {vn: {k: canonical(leaf)
                        for k, leaf in self._pool[vn].items()}
                   for vn in self._paged_names}
        return pack_snapshot(
            req=req, pos=pos, count=self._counts[slot],
            last=self._last[slot], key=self._keys[slot].copy(),
            kv_dtype=self.kv_dtype, page_size=self._ps,
            page_token_bytes=self._page_token_bytes, page_digests=digests,
            fetched=fetched, n_pages=n, shards=self._tp)

    def _handoff_fault(self, snap: KVSnapshot):
        """One chaos draw per snapshot shipped (none without a policy):
        ``corrupt`` and ``truncate`` damage the wire content so the
        adopter's checksum fails; returns the mode (``drop`` included)."""
        mode = None if self._chaos is None \
            else self._chaos.handoff_fault_mode()
        if mode == "corrupt":
            corrupt_snapshot(snap)
        elif mode == "truncate":
            truncate_snapshot(snap)
        return mode

    def _publish_snapshot(self, req: _Request, snap: KVSnapshot):
        """Count the export and attach the snapshot to the request's future
        (``future._kv_snapshot``): whoever holds the future reads it when
        the request fails mid-stream. An injected ``drop`` attaches
        nothing (the consumer falls back to what it already had)."""
        if self._handoff_fault(snap) == "drop":
            return
        self._m_handoff_snapshots.inc()
        self._m_handoff_bytes.inc(snap.wire_bytes())
        req.future._kv_snapshot = snap

    def _transfer_loop(self, exports):
        """Disaggregated-prefill transfer: each freshly prefilled
        ``export_kv`` slot leaves as a ``KVSnapshot``, the future's result,
        and its pages free at once (the prefill tier's short residency). A
        snapshot failure degrades to co-located decode here; an injected
        drop fails the request ``SnapshotUnavailable`` (no snapshot), so a
        fleet re-prefills it elsewhere."""
        for slot, req in exports:
            if self._slot_req[slot] is not req:
                continue  # retired or expired between commit and transfer
            try:
                snap = self._snapshot_slot(slot)
            except Exception:  # noqa: BLE001 — degrade to co-located
                # decode: the slot stays active and streams here
                self._m_handoff_fallbacks.inc()
                continue
            mode = self._handoff_fault(snap)
            self._vacate(slot)
            if mode == "drop":
                self._m_failed.inc()
                self._fail(req, SnapshotUnavailable(
                    "handoff transfer dropped in flight"))
                continue
            self._m_handoff_snapshots.inc()
            self._m_handoff_bytes.inc(snap.wire_bytes())
            self._m_prefill_exports.inc()
            self._m_retired.inc()
            self._m_completed.inc()
            try:
                req.future.set_result(snap)
            except Exception:  # caller gave up
                pass

    def _maybe_snapshot_slots(self):
        """Periodic snapshots: at most ONE slot per round, the most overdue,
        so exports never crowd out decode dispatches. Best effort: a
        snapshot that cannot be taken leaves the slot as it was."""
        if not self.snapshot_every:
            return
        best, best_lag = -1, 0
        for s in range(self.slots):
            if self._slot_req[s] is None:
                continue
            lag = int(self._counts[s]) - self._snap_counts[s]
            if lag >= self.snapshot_every and lag > best_lag:
                best, best_lag = s, lag
        if best < 0:
            return
        req = self._slot_req[best]
        try:
            snap = self._snapshot_slot(best)
        except Exception:  # noqa: BLE001 — best effort, as the docstring
            return
        self._snap_counts[best] = int(self._counts[best])
        self._publish_snapshot(req, snap)

    def _service_exports(self):
        """Resolve queued ``export_request`` handshakes between dispatches
        (the loop thread is the only one near the pool). A request no longer
        resident in a slot is ``SnapshotUnavailable``."""
        while True:
            with self._cond:
                if not self._export_q:
                    return
                fut_in, out = self._export_q.popleft()
            slot = next((s for s in range(self.slots)
                         if self._slot_req[s] is not None
                         and self._slot_req[s].future is fut_in), -1)
            if slot < 0:
                self._fail_export(out, SnapshotUnavailable(
                    "request is not resident in a decode slot (never "
                    "admitted, already retired, or failed)"))
                continue
            try:
                snap = self._snapshot_slot(slot)
            except Exception as e:  # noqa: BLE001 — typed to the caller
                self._fail_export(out, e)
                continue
            self._snap_counts[slot] = int(self._counts[slot])
            self._publish_snapshot(self._slot_req[slot], snap)
            try:
                out.set_result(snap)
            except Exception:  # caller gave up
                pass

    @staticmethod
    def _fail_export(out: Future, exc: BaseException):
        try:
            out.set_exception(exc)
        except Exception:  # caller gave up
            pass

    def export_request(self, future, timeout: Optional[float] = 30.0
                       ) -> KVSnapshot:
        """Snapshot the live request behind ``future`` (as ``submit``
        returned it). Blocks until the serving loop services the export
        between dispatches, never longer than the request's own remaining
        deadline (expiry raises ``DeadlineExceeded``). Raises
        ``SnapshotUnavailable`` when the request is not resident in a
        slot, ``SnapshotUnsupported`` on a speculative server."""
        if self._draft is not None:
            raise SnapshotUnsupported(
                "speculative servers cannot export: the draft's dense "
                "KV cache is not part of the KVSnapshot wire format")
        deadline = getattr(future, "_deadline", None)
        eff = timeout
        if deadline is not None:
            rem = deadline.remaining()
            if rem <= 0:
                raise DeadlineExceeded(
                    "request budget exhausted before the export "
                    f"({-rem * 1e3:.1f} ms over)")
            eff = rem if eff is None else min(eff, rem)
        out: Future = Future()
        with self._cond:
            if self._closing:
                raise RuntimeError("GenerationServer is closed")
            self._export_q.append((future, out))
            self._cond.notify_all()
        try:
            return out.result(timeout=eff)
        except FutureTimeout:
            if deadline is not None and deadline.expired():
                raise DeadlineExceeded(
                    "request budget exhausted waiting for the export "
                    f"({-deadline.remaining() * 1e3:.1f} ms over)")
            raise

    def adopt_request(self, snapshot: KVSnapshot, *,
                      deadline_s: Optional[float] = None) -> Future:
        """Rebuild a snapshotted request into this server and resume
        decoding at position N. Validation is typed and up front:
        ``SnapshotInvalid`` (checksum, version or an inconsistent header),
        ``SnapshotUnsupported`` (kv dtype or page geometry of another
        server, or a speculative server), ``ServerOverloaded`` (page budget
        or admission watermark), ``CircuitOpen``. The resumed completion
        equals the uninterrupted one: the serial ``fold_in(key,
        token_index)`` schedule rides in the snapshot."""
        if self._draft is not None:
            raise SnapshotUnsupported(
                "speculative servers cannot adopt: the draft's dense "
                "KV cache is not part of the KVSnapshot wire format")
        if snapshot.version not in (WIRE_VERSION - 1, WIRE_VERSION):
            raise SnapshotInvalid(
                f"KVSnapshot wire version {snapshot.version} != "
                f"supported {WIRE_VERSION}")
        if not snapshot.verify():
            raise SnapshotInvalid("KVSnapshot checksum mismatch")
        if (snapshot.kv_dtype != self.kv_dtype
                or snapshot.page_size != self._ps
                or snapshot.page_token_bytes != self._page_token_bytes
                or snapshot.head_layout != "canonical"):
            raise SnapshotUnsupported(
                f"snapshot geometry (kv_dtype={snapshot.kv_dtype!r}, "
                f"page_size={snapshot.page_size}, "
                f"{snapshot.page_token_bytes} B/token, "
                f"head_layout={snapshot.head_layout!r}) does not match "
                f"this server (kv_dtype={self.kv_dtype!r}, "
                f"page_size={self._ps}, {self._page_token_bytes} "
                "B/token, head_layout='canonical')")
        plen = int(snapshot.prompt.shape[0])
        if (snapshot.count != len(snapshot.tokens)
                or snapshot.pos != plen + snapshot.count - 1
                or snapshot.n_pages != -(-snapshot.pos // self._ps)):
            raise SnapshotInvalid(
                "inconsistent KVSnapshot header: position/count/page "
                "stack disagree with the token history")
        self._check_fits(plen, snapshot.max_tokens, "adoption")
        self._check_breaker()
        # an explicit deadline_s wins, then the remaining budget the
        # snapshot carried (a duration, re-armed on this host's clock),
        # then this server's default
        budget = deadline_s
        if budget is None:
            budget = snapshot.deadline_remaining
        if budget is None:
            budget = self.request_deadline_s
        req = _Request(snapshot.prompt.astype(np.int64), snapshot.max_tokens,
                       snapshot.temperature, snapshot.top_k, snapshot.seed,
                       snapshot.eos_id,
                       None if budget is None else Deadline(budget))
        req.tokens = list(snapshot.tokens)
        req.snapshot = snapshot
        return self._enqueue(req)

    def _adopt_into_slot(self, slot: int, req: _Request) -> bool:
        """Rebuild ``req.snapshot`` into slot ``slot``: pages whose chunk
        digest is resident are shared out of the prefix cache, the rest are
        stored in one scatter per pool leaf, the pristine prompt pages are
        registered for future sharers, and the decode mirrors resume at
        position N. Returns False after rolling back under pool pressure;
        the caller then prefills from token 0."""
        snap = req.snapshot
        pool = self._page_pool
        sp = self._slot_pages[slot]
        n = snap.n_pages
        stored = []                                # logical pages uploaded
        try:
            for i in range(n):
                d = snap.page_digests[i]
                page = pool.lookup(d) \
                    if (d is not None and self.prefix_cache) else None
                if page is not None:
                    pool.share(page)
                else:
                    page = self._alloc_page(slot)
                    stored.append(i)
                self._bt[slot, i] = page
                sp.append(page)
        except RuntimeError:
            # pool exhausted mid-adoption: roll back and prefill from
            # token 0 instead (admission proved the request feasible)
            self._release_slot_pages(slot)
            req.snapshot = None
            req.tokens.clear()
            self._m_handoff_fallbacks.inc()
            return False
        if stored:
            dst = torch.tensor([sp[i] for i in stored], dtype=torch.long)
            rows = torch.tensor(stored, dtype=torch.long)
            for vn in self._paged_names:
                for k, leaf in self._pool[vn].items():
                    data = _from_wire(snap.payload[vn][k]).index_select(
                        0, rows)
                    # the canonical heads split by this server's tp
                    for a, part in zip(leaf, data.chunk(len(leaf), dim=1)):
                        a.index_copy_(0, dst.to(a.device), part.to(
                            device=a.device, dtype=a.dtype))
        # register the pristine prompt chunk pages (the tail page already
        # holds decoded tokens and is not registered under the tail key)
        plen = req.prompt.shape[0]
        if self.prefix_cache:
            for i, digest in enumerate(
                    self._chunk_digests(req.prompt, min(plen // self._ps, n))):
                pool.register(digest, sp[i])
        self._last[slot] = snap.last
        self._counts[slot] = snap.count
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._keys[slot] = snap.key.astype(np.int64)
        self._pos[slot] = snap.pos
        self._snap_counts[slot] = snap.count
        req.snapshot = None
        self._activate(slot, req)
        self._m_handoff_resumes.inc()
        self._m_handoff_saved.inc(len(req.tokens))
        if req.tokens and self._finished(req, req.tokens[-1]):
            self._retire(slot, req)
        return True

    def _migrate_out(self):
        """Drain-migrate sweep (loop thread): every live slot is
        snapshotted at its stream position and failed ``RequestMigrated``
        with the snapshot attached to its future (and handed to the
        ``drain(migrate=callable)`` sink), so whoever migrates it adopts
        it elsewhere without losing a token. Queued requests migrate with
        whatever snapshot they already carry (usually none: token-0
        redispatch). A speculative server migrates without snapshots."""
        with self._cond:
            cb = self._migrate_cb
            self._migrating = False
            self._migrate_cb = None
            queued = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for req in queued:
            if req.snapshot is not None:
                req.future._kv_snapshot = req.snapshot
            self._m_migrated.inc()
            self._fail(req, RequestMigrated(
                "request migrated off a draining server before prefill"))
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            snap = None
            if self._draft is None:
                try:
                    snap = self._snapshot_slot(s)
                except Exception:  # noqa: BLE001 — degrade to token-0
                    snap = None
            if snap is not None:
                self._publish_snapshot(req, snap)
                if cb is not None:
                    try:
                        cb(snap)
                    except Exception:  # a sink's error never loses the
                        pass           # request
            self._vacate(s)
            self._m_migrated.inc()
            self._fail(req, RequestMigrated(
                "request migrated off a draining server after "
                f"{len(req.tokens)} tokens"))

    # --------------------------------------------------------- lifecycle
    def drain(self, timeout: Optional[float] = None, *,
              migrate=False) -> bool:
        """Block until every queued and in-flight request has resolved.
        Returns False on timeout. ``migrate`` truthy moves live requests
        out instead of decoding them to completion: each is snapshotted
        and failed ``RequestMigrated`` with the snapshot at
        ``future._kv_snapshot``; a callable also receives each
        ``KVSnapshot`` as it is exported."""
        if migrate:
            with self._cond:
                self._migrating = True
                self._migrate_cb = migrate if callable(migrate) else None
                self._cond.notify_all()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._n_active:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(timeout=0.05 if left is None
                                else min(left, 0.05))
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, drain what is in flight, stop the loop. Any
        request or export still unresolved past ``timeout`` fails typed.
        Idempotent and re-entrant: safe from any thread, twice, or
        concurrently (the runtime serializes the shutdown)."""
        with self._cond:
            # before the drain begins, so a chaos kill landing mid-drain
            # cannot win a restart race against this deliberate close
            self._user_close = True
        self._runtime.begin_drain()   # submit() now rejects typed
        self.drain(timeout)
        self._runtime.close(max(timeout, 1.0))
        with self._cond:
            stragglers = [s for s in range(self.slots)
                          if self._slot_req[s] is not None]
            victims = [self._slot_req[s] for s in stragglers]
            victims += list(self._queue)
            self._queue.clear()
            self._slot_req = [None] * self.slots
            self._n_active = 0
            exports = list(self._export_q)
            self._export_q.clear()
        for _fut, out in exports:  # never leave an exporter hung
            self._fail_export(out, SnapshotUnavailable(
                "GenerationServer closed before the export was serviced"))
        for s in stragglers:   # the loop thread is joined: safe to touch
            self._release_slot_pages(s)
        for req in victims:
            self._fail(req, RuntimeError("GenerationServer closed with the "
                                         "request still in flight"))
        # un-push the paged-attention override: layer config belongs to the
        # net, and the next server over this net must see its own knob
        for name, prev in self._pa_prev.items():
            self._layer_by_name[name].paged_attention = prev
        self._pa_prev = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Serving counters, read off the registry: the JAX server's keys
        in its order (``_cond`` is held only for occupancy and queue
        depth; page gauges are racy-but-atomic reads of loop-owned
        state)."""
        with self._cond:
            n_active = self._n_active
            queued = len(self._queue)
        busy_s = self._m_busy_s.value
        tokens = int(self._m_tokens.value)
        out = {
            "slots": self.slots,
            "active_slots": n_active,
            "queued": queued,
            "admitted": int(self._m_admitted.value),
            "expired": int(self._m_expired.value),
            "retired": int(self._m_retired.value),
            "completed": int(self._m_completed.value),
            "failed": int(self._m_failed.value),
            "retried": int(self._m_retried.value),
            "pool_rebuilds": int(self._m_pool_rebuilds.value),
            "prefills": int(self._m_prefills.value),
            "decode_steps": int(self._m_decode_steps.value),
            "tokens_generated": tokens,
            "tokens_per_s": (tokens / busy_s if busy_s > 0 else 0.0),
        }
        out.update(accepted=self.admission.accepted,
                   rejected=self.admission.rejected,
                   pending=self.admission.pending,
                   breaker_state=self.breaker.state)
        pool = self._page_pool
        proposed = int(self._m_spec_proposed.value)
        accepted = int(self._m_spec_accepted.value)
        out["pages"] = {
            "page_size": self._ps,
            "pages_total": pool.total,
            "pages_free": len(pool.free),
            "pages_cached": len(pool.cache),
            "pages_shared": pool.shared_count(),
            "pages_refcounted": pool.refcounted(),
            "resident_kv_bytes": pool.in_use() * self._page_bytes,
            "peak_resident_kv_bytes": pool.peak * self._page_bytes,
            "cow_copies": int(self._m_cow_copies.value),
            "prefix_hits": int(self._m_prefix_hits.value),
            "prefix_tokens_reused": int(self._m_prefix_reused.value),
            "evictions": int(pool.evictions),
            "preempted": int(self._m_preempted.value),
            "spec_k": self.spec_k if self._draft is not None else 0,
            "spec_rounds": int(self._m_spec_rounds.value),
            "spec_proposed": proposed,
            "spec_accepted": accepted,
            "spec_accept_rate": (accepted / proposed) if proposed else 0.0,
            "kv_cache_dtype": self.kv_dtype or self.net.conf.dtype,
            "bytes_per_token": self._page_token_bytes,
        }
        out["handoff"] = {
            "snapshot_every": self.snapshot_every,
            "snapshots": int(self._m_handoff_snapshots.value),
            "bytes": int(self._m_handoff_bytes.value),
            "resumes": int(self._m_handoff_resumes.value),
            "tokens_saved": int(self._m_handoff_saved.value),
            "fallbacks": int(self._m_handoff_fallbacks.value),
            "preempt_resumes": int(self._m_preempt_resumes.value),
            "migrated": int(self._m_migrated.value),
            "prefill_exports": int(self._m_prefill_exports.value),
        }
        out["role"] = self.role
        return out
