"""Continuous-batching generation serving over a PAGED KV-cache pool (port of
the core of ``deeplearning4j_tpu/parallel/generation.py``).

``GenerationServer`` runs iteration-level (continuous) batching over a fixed
pool of S decode slots and stores every slot's KV cache in a shared pool of
fixed-size pages behind a block table:

- The device keeps one ``[pages, H, page_size, d]`` K/V pool per attention
  layer (plus ``[pages, H, page_size]`` f32 scale planes under
  ``kv_dtype="int8"``). A host-owned ``[S, max_pages]`` int32 block table
  maps each slot to its pages and rides into every forward as data. Page 0
  is the garbage page that inactive rows and padded columns write into.
- Admission is page accounting: ``submit()`` rejects a request whose prompt
  + max_tokens can never fit with a typed ``ServerOverloaded`` up front.
- A wave of admitted prompts is prefilled together, Sarathi-style: rounds of
  at most ``prefill_chunk`` tokens per row, one batched paged forward per
  round, rows not in the wave routed to the garbage page.
- Each decode dispatch advances every active slot ``steps_per_dispatch``
  micro-steps, each a paged forward through the paged-attention kernel,
  with ONE ``[S, M]`` token copy to the host per dispatch. Rows write-clamp
  at capacity: a row at ``NP * page_size`` freezes and its block-table row
  swaps to the garbage page.

Requests are greedy or sampled (``temperature``, ``top_k``, ``seed``). A
request's token i is selected with ``fold_in(PRNGKey(seed), i)`` (the
threefry keys of ``ops/random.py``), the JAX server's serial key schedule,
so its stream equals ``sample_generate``'s and the JAX server's for the same
probabilities. A dispatch whose active rows are all greedy takes the plain
argmax, as the JAX server's ``lax.cond`` does.

The decode loop runs on one plain thread the server owns. Prefix sharing
with copy-on-write, preemption, speculative decode, snapshots and handoff,
tensor-parallel meshes, deadlines, retries, the circuit breaker, chaos
injection, the metrics registry and serving roles are not ported yet
(ROADMAP A3).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.models.zoo import (lm_stream_forward,
                                             sampled_next_token)
from deeplearning4j_torch.nn.conf.layers.attention import (
    PositionalEncodingLayer, SelfAttentionLayer)
from deeplearning4j_torch.nn.conf.layers.paged_attention import CHOICES
from deeplearning4j_torch.ops import random
from deeplearning4j_torch.optimize.bucketing import bucket_pages
from deeplearning4j_torch.parallel.resilience import (AdmissionController,
                                                      ServerOverloaded)

_UNSET = object()

#: pool page 0 never backs real tokens: inactive slots' block-table rows
#: are all zeros, so their masked garbage writes land here
GARBAGE_PAGE = 0


class _Request:
    __slots__ = ("prompt", "max_tokens", "temperature", "top_k", "seed",
                 "eos_id", "future", "tokens")

    def __init__(self, prompt, max_tokens, temperature, top_k, seed, eos_id):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.eos_id = eos_id
        self.future = Future()
        self.tokens: list = []


class _PagePool:
    """Host-side accounting for the device page pool: a free stack and
    per-page refcounts. Page 0 is the reserved garbage page. Owned by the
    serving loop thread."""

    def __init__(self, pages: int):
        self.total = int(pages)
        self.free = list(range(self.total - 1, 0, -1))  # pop() -> page 1
        self.ref = [0] * self.total
        self.peak = 0

    def in_use(self) -> int:
        return self.total - 1 - len(self.free)

    def alloc(self) -> Optional[int]:
        """One page at refcount 1; None when the pool is exhausted."""
        if not self.free:
            return None
        page = self.free.pop()
        self.ref[page] = 1
        self.peak = max(self.peak, self.in_use())
        return page

    def release(self, page: int) -> None:
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.free.append(page)


class GenerationServer:
    """Paged continuous-batching decode server for a causal LM, greedy or
    sampled per request.

    ``net`` is a port ``ComputationGraph`` whose attention layers page their
    KV (TransformerLM). ``submit`` returns a ``concurrent.futures.Future``
    resolving to the generated token ids (numpy int64, EOS included when
    hit). ``device`` defaults to CUDA and must be the net's device.

    ``page_size`` must divide the attention ``max_cache``; ``pages`` defaults
    to ``slots * max_cache / page_size + 1`` (every slot at full capacity
    plus the garbage page). ``paged_attention`` (None keeps each layer's
    knob) is pushed onto every paged layer and restored on close.
    """

    def __init__(self, net, vocab: int, *, slots: int = 8,
                 eos_id: Optional[int] = None,
                 max_pending: int = 64,
                 min_prefill_bucket: int = 8,
                 prefill_chunk: int = 256,
                 page_size: int = 16,
                 pages: Optional[int] = None,
                 steps_per_dispatch: int = 4,
                 kv_dtype: Optional[str] = None,
                 paged_attention: Optional[str] = None,
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
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ValueError(f"the net lives on {net.device}, the server on "
                             f"{self.device}; init the net on the server's "
                             "device")
        self.net = net
        self.vocab = int(vocab)
        self.slots = int(slots)
        self.eos_id = eos_id
        self.min_prefill_bucket = int(min_prefill_bucket)
        self.prefill_chunk = int(prefill_chunk)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.kv_dtype = kv_dtype
        self.paged_attention = paged_attention
        self.admission = AdmissionController(max_pending)
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

        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._slot_req: list = [None] * self.slots
        self._n_active = 0
        self._closing = False
        self._stop = False

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
        self._page_pool = _PagePool(self.pages_total)
        self._counters = dict(admitted=0, completed=0, failed=0, prefills=0,
                              prefill_rounds=0, decode_steps=0,
                              tokens_generated=0, busy_s=0.0)

        self._fwd = lm_stream_forward(net)
        self._pool = self._fresh_pool()
        self._thread = threading.Thread(target=self._run,
                                        name="generation-server",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------ introspection
    def _probe_net(self):
        """Classify the net's streaming layers: which hold pageable KV, which
        only carry positions; derive the block-table geometry from the KV
        capacity."""
        self._paged_names: list = []
        self._pos_names: list = []
        self._layer_by_name: dict = {}
        self._pa_prev: dict = {}
        caps = []
        for name, layer in self.net._stream_layers():
            if isinstance(layer, SelfAttentionLayer) and layer.causal:
                self._layer_by_name[name] = layer
                self._paged_names.append(name)
                caps.append(layer.max_cache)
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

    def _fresh_pool(self):
        dtype = getattr(torch, self.net.conf.dtype)
        return {name: self._layer_by_name[name].init_paged_carry(
            self.pages_total, self._ps, dtype, kv_dtype=self.kv_dtype,
            device=self.device) for name in self._paged_names}

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
    def submit(self, prompt_ids, max_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               eos_id=_UNSET) -> Future:
        """Queue one generation request; returns a Future resolving to the
        generated ids (<= max_tokens, shorter when ``eos_id`` — the
        per-request one or the server default — is produced, which is
        included). ``temperature`` 0 is greedy; otherwise tokens are
        sampled from the softmax sharpened by 1/temperature, among the
        ``top_k`` most likely when ``top_k > 0``, with token i keyed by
        ``fold_in(PRNGKey(seed), i)``. Raises ``ServerOverloaded`` when the
        request can never fit the page budget or the admission watermark
        is reached."""
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
        plen = int(prompt.shape[0])
        need_tokens = plen + int(max_tokens) - 1
        if need_tokens > self._cap_tokens:
            raise ServerOverloaded(
                f"infeasible request: prompt {plen} + max_tokens "
                f"{max_tokens} exceeds the per-slot KV capacity "
                f"{self._cap_tokens} ({self._np} pages x {self._ps})")
        need_pages = -(-need_tokens // self._ps)
        if need_pages > self.pages_total - 1:
            raise ServerOverloaded(
                f"infeasible request: needs {need_pages} pages but the "
                f"pool capacity is {self.pages_total - 1} usable pages "
                f"of {self._ps} tokens")
        with self._cond:
            if self._closing:
                raise RuntimeError("GenerationServer is closed")
        req = _Request(prompt.astype(np.int64), int(max_tokens),
                       float(temperature), int(top_k), int(seed),
                       self.eos_id if eos_id is _UNSET else eos_id)
        random.seed_words(req.seed)     # an out-of-range seed fails here
        self.admission.acquire()  # raises ServerOverloaded at watermark
        req.future.add_done_callback(lambda _f: self.admission.release())
        with self._cond:
            if self._closing:
                self._fail(req, RuntimeError("GenerationServer is closed"))
                return req.future
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    # ---------------------------------------------------------- the loop
    def _run(self):
        with torch.inference_mode():
            while self._tick_once():
                pass

    def _tick_once(self) -> bool:
        """One scheduling round: admit and prefill a wave, then one decode
        dispatch. Returns False only on a clean stop."""
        with self._cond:
            if self._stop:
                return False
            if not self._queue and self._n_active == 0:
                self._cond.wait(timeout=0.5)
                return True
        try:
            self._admit_free_slots()
            with self._cond:
                n_active = self._n_active
            if n_active:
                t0 = time.monotonic()
                self._decode_once()
                self._counters["busy_s"] += time.monotonic() - t0
        except Exception as e:  # noqa: BLE001 — a loop death would hang
            # every outstanding future; fail them typed instead
            self._fail_all(e)
        return True

    def _admit_free_slots(self):
        """Admit every queued request a free slot and the page pool can
        take, then prefill the whole wave together."""
        staged = []                                 # (slot, req, plen)
        for s in range(self.slots):
            if self._slot_req[s] is not None:
                continue
            with self._cond:
                if not self._queue:
                    break
                req = self._queue.popleft()
            plen = req.prompt.shape[0]
            try:
                self._ensure_slot_pages(s, plen)
            except RuntimeError as e:  # pool exhausted during staging
                self._release_slot_pages(s)
                if staged:
                    # their completions free the pages this one needs
                    with self._cond:
                        self._queue.appendleft(req)
                    break
                self._counters["failed"] += 1
                self._fail(req, e)
                continue
            staged.append((s, req, plen))
        if staged:
            t0 = time.monotonic()
            self._prefill_wave(staged)
            self._counters["busy_s"] += time.monotonic() - t0

    # -------------------------------------------------- page bookkeeping
    def _release_slot_pages(self, slot: int):
        sp = self._slot_pages[slot]
        for page in sp:
            self._page_pool.release(page)
        sp.clear()
        self._bt[slot, :] = GARBAGE_PAGE
        self._pos[slot] = 0

    def _alloc_page(self) -> int:
        page = self._page_pool.alloc()
        if page is None:
            raise RuntimeError(
                "page pool exhausted (preemption is not ported): raise "
                "`pages` or lower `slots`")
        return page

    def _ensure_slot_pages(self, slot: int, upto: int):
        """Slot ``slot`` is about to write positions below ``upto``:
        allocate any missing pages (no page is shared, so none needs a
        copy before the write)."""
        sp = self._slot_pages[slot]
        n = -(-upto // self._ps)
        if n > self._np:
            raise RuntimeError(
                f"slot {slot} needs {n} pages > block table width "
                f"{self._np} — admission should have rejected this")
        while len(sp) < n:
            page = self._alloc_page()
            self._bt[slot, len(sp)] = page
            sp.append(page)

    def _reserve_decode_pages(self):
        """Pages for one decode dispatch: every active slot gets pages
        covering its next ``steps_per_dispatch`` writes, up to the per-slot
        capacity (the dispatch write-clamps there)."""
        for s in range(self.slots):
            if self._slot_req[s] is None:
                continue
            pos = int(self._pos[s])
            upto = min(pos + self.steps_per_dispatch, self._cap_tokens)
            if upto > pos:
                self._ensure_slot_pages(s, upto)

    def _trim_slot_pages(self, slot: int, plen: int):
        """Drop pages wholly beyond the next write position."""
        sp = self._slot_pages[slot]
        keep = plen // self._ps + 1
        while len(sp) > keep:
            page = sp.pop()
            self._bt[slot, len(sp)] = GARBAGE_PAGE
            self._page_pool.release(page)

    # ------------------------------------------------------ prefill path
    def _prefill_wave(self, group):
        """Batched chunked prefill for one admission wave: every staged slot
        advances through rounds of at most ``prefill_chunk`` tokens, ONE
        paged forward per round for the rows with prompt left. A row takes
        its first token in the round that consumes its final chunk."""
        S = self.slots
        cur = {s: 0 for s, _, _ in group}
        first = {}
        keys = np.zeros((S, 2), np.int64)
        for s, req, _ in group:
            keys[s] = random.seed_words(req.seed)
        cap_pages = max(1, self._chunk_cap // self._ps)
        while True:
            live = [(s, req, plen) for s, req, plen in group
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
            toks = self._prefill_round(ids, mask, admit, positions, sufflen,
                                       temp, topk, keys)
            for s, _, plen in live:
                cur[s] += chunk[s]
                if cur[s] >= plen:
                    first[s] = toks[s]
        for s, req, plen in group:
            self._commit_slot(s, req, plen, first[s], keys[s])

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
        out, _ = self._fwd(self.net.params, self.net.state, x, carry, mask_t)
        rows = out[torch.arange(self.slots, device=self.device),
                   self._to_dev(sufflen) - 1]
        self._counters["prefill_rounds"] += 1
        sampling = self._sampling(temp, topk, keys)
        first = None if sampling is None else torch.zeros(
            self.slots, dtype=torch.int64, device=self.device)
        return self._select(rows, sampling, first).cpu().tolist()

    def _commit_slot(self, slot: int, req: _Request, plen: int, tok, key):
        """Publish one prefilled slot: trim the bucket over-allocation, seed
        the decode mirrors (its next token is token 1 of its key
        schedule), and mark the slot active."""
        self._trim_slot_pages(slot, plen)
        self._last[slot] = tok
        self._pos[slot] = plen
        self._counts[slot] = 1
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._keys[slot] = key
        req.tokens.append(tok)
        with self._cond:
            self._slot_req[slot] = req
            self._n_active += 1
        self._counters["prefills"] += 1
        self._counters["admitted"] += 1
        self._counters["tokens_generated"] += 1
        if self._finished(req, tok):
            self._retire(slot, req)

    # ------------------------------------------------------- decode path
    def _active_mask(self):
        return np.array([r is not None for r in self._slot_req])

    def _paged_step(self, bt, positions, last, active, temp, topk, keys,
                    counts):
        """``steps_per_dispatch`` micro-steps, each one paged forward over
        all S rows and one token select (``temp``, ``topk``, ``keys`` and
        ``counts`` are host arrays: the active slots' sampling values,
        others zeroed, and each slot's next token index). Returns the
        ``[S, M]`` tokens on the device."""
        dtype = getattr(torch, self.net.conf.dtype)
        cap = bt.shape[1] * self._ps
        pos, cur = positions, last
        sampling = self._sampling(temp, topk, keys)
        cnt = None if sampling is None else self._to_dev(counts)
        seq = []
        for _ in range(self.steps_per_dispatch):
            # write-clamp: rows at capacity freeze, and their WHOLE
            # block-table row swaps to the garbage page so the clamped
            # column write lands there instead of on real KV at cap-1
            act = active & (pos < cap)
            posw = torch.clamp(pos, max=cap - 1)
            bt_eff = torch.where(act[:, None], bt, torch.zeros_like(bt))
            x = F.one_hot(cur, self.vocab).to(dtype)[:, None, :]
            out, _ = self._fwd(self.net.params, self.net.state, x,
                               self._carry(bt_eff, posw))
            nxt = self._select(out[:, 0], sampling, cnt)
            cur = torch.where(act, nxt, cur)
            pos = torch.where(act, pos + 1, pos)
            if cnt is not None:
                cnt = torch.where(act, cnt + 1, cnt)
            seq.append(cur)
        return torch.stack(seq, dim=1)

    def _decode_once(self):
        self._reserve_decode_pages()
        active = self._active_mask()
        seq = self._paged_step(self._to_dev(self._bt), self._to_dev(self._pos),
                               self._to_dev(self._last),
                               self._to_dev(active),
                               np.where(active, self._temp, 0).astype(
                                   np.float32),
                               self._topk, self._keys, self._counts)
        toks = seq.cpu().numpy()       # ONE [S, M] copy per dispatch
        m_steps = self.steps_per_dispatch
        ntok = 0
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            done = False
            for tok in toks[s].tolist():
                req.tokens.append(tok)
                ntok += 1
                if self._finished(req, tok):
                    done = True
                    break
            # the device advanced the full window (write-clamped at the
            # capacity) regardless of where the request finished
            adv = min(m_steps, self._cap_tokens - self._pos[s])
            self._pos[s] += adv
            self._counts[s] += adv
            self._last[s] = toks[s, m_steps - 1]
            if done:
                self._retire(s, req)
        self._counters["decode_steps"] += 1
        self._counters["tokens_generated"] += ntok

    def _finished(self, req: _Request, tok) -> bool:
        if req.eos_id is not None and tok == req.eos_id:
            return True
        return len(req.tokens) >= req.max_tokens

    def _retire(self, slot: int, req: _Request):
        self._release_slot_pages(slot)
        with self._cond:
            self._slot_req[slot] = None
            self._n_active -= 1
            self._cond.notify_all()
        self._counters["completed"] += 1
        try:
            req.future.set_result(np.asarray(req.tokens, np.int64))
        except Exception:  # future cancelled by the caller
            pass

    def _fail(self, req: _Request, exc: BaseException):
        try:
            req.future.set_exception(exc)
        except Exception:  # already resolved/cancelled
            pass

    def _fail_all(self, exc: BaseException):
        """Hard dispatch fault: every in-flight request fails typed (never
        hangs) and the page pool is rebuilt from zeros."""
        with self._cond:
            victims = [r for r in self._slot_req if r is not None]
            victims += list(self._queue)
            self._queue.clear()
            self._slot_req = [None] * self.slots
            self._n_active = 0
            rebuild = not self._closing
            self._cond.notify_all()
        self._counters["failed"] += len(victims)
        for req in victims:
            self._fail(req, exc)
        if rebuild:
            self._page_pool = _PagePool(self.pages_total)
            self._bt[:] = GARBAGE_PAGE
            self._pos[:] = 0
            self._slot_pages = [[] for _ in range(self.slots)]
            self._pool = self._fresh_pool()

    # --------------------------------------------------------- lifecycle
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued and in-flight request has resolved.
        Returns False on timeout."""
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
        """Stop admitting, drain what is in flight, stop the loop thread.
        Any request still unresolved past ``timeout`` fails typed.
        Idempotent."""
        with self._cond:
            self._closing = True
        self.drain(timeout)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if threading.current_thread() is not self._thread:
            self._thread.join(max(timeout, 1.0))
        with self._cond:
            victims = [r for r in self._slot_req if r is not None]
            victims += list(self._queue)
            self._queue.clear()
            self._slot_req = [None] * self.slots
            self._n_active = 0
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
        """Serving counters (racy-but-atomic reads of loop-owned state)."""
        c = dict(self._counters)
        busy = c["busy_s"]
        with self._cond:
            c.update(slots=self.slots, active_slots=self._n_active,
                     queued=len(self._queue))
        c["tokens_per_busy_s"] = c["tokens_generated"] / busy if busy else 0.0
        pool = self._page_pool
        c["pages"] = {"page_size": self._ps, "pages_total": pool.total,
                      "pages_free": len(pool.free), "peak_in_use": pool.peak,
                      "kv_cache_dtype": self.kv_dtype or self.net.conf.dtype}
        c.update(accepted=self.admission.accepted,
                 rejected=self.admission.rejected,
                 pending=self.admission.pending)
        return c
