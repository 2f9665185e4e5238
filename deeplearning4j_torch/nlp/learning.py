"""SkipGram / CBOW / DBOW training updates on torch tensors (the port of
``deeplearning4j_tpu/nlp/learning.py``).

Reference: models/embeddings/learning/impl/elements/SkipGram.java:215-272.
B (row, predicted) pairs go through one batched update: gather rows ->
sigmoid dots -> scatter-add updates. The JAX package runs the S batches of
a corpus block as one ``lax.scan``; here they are a loop over the batches
on the tables' device, with the same per-batch arithmetic. The gradients
are closed-form (logistic regression), not autodiff.

Duplicate-row stabilisation (the JAX module's ``DUP_CAP``): a batched
scatter sums every contribution computed from the same stale row, so each
scatter caps the accumulated per-row step at DUP_CAP effective
contributions, scale = min(1, cap/count).

Scatter-adds (``_scatter_add``) are ``index_add_``. On the CPU it loops
over the indices in order, as JAX's ``.at[].add`` does on the CPU, so two
runs give the same tables (``index_put_(accumulate=True)`` there is
threaded with atomic adds, and two runs differ). On CUDA it adds with
atomics, in an order that varies from run to run: the sort-based
``index_put_(accumulate=True)`` would be repeatable, but it adds a row's
duplicates one after another in one warp, and a Zipf corpus puts ~10^4
of them on its hottest rows in every batch (about 6 ms a batch at the
JAX bench leg on an H100 80GB HBM3). The ``segment_updates`` path sums
its segments with the same adds, so it is not repeatable on CUDA either.
Where the summation order differs from JAX's (the atomics, the einsum
products, the linear learning-rate ramp), the tables are allclose to
JAX's, not bitwise.

Random draws are bitwise JAX's (``ops/random.py``): the shrinking-window
widths ``randint(kw, (N,), 1, W + 1)`` and the per-batch negatives
``randint(fold_in(kn, i), (B, K), 0, table)``, drawn here for a chunk of
batches at once.

HS pair layout: for each pair, up to L huffman (point, code) levels with a
validity mask. NS layout: K negatives per pair from the unigram^0.75 table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch.ops import random as prandom

DUP_CAP = 16.0  # max effective duplicate contributions per row per batch

#: draws per chunk of batches' negatives (int64 words, a few copies live)
_DRAW_CHUNK = 1 << 22


def _scatter_add(table, idx, upd):
    """``table[idx] += upd`` row by row (a table of any rank; ``upd`` has
    ``idx``'s shape followed by a row's), duplicates summed (in index order
    on the CPU; see the module docstring). In place; returns ``table``."""
    return table.index_add_(0, idx.reshape(-1),
                            upd.reshape(-1, *table.shape[1:]))


def _row_mean_scale(num_rows, idx, weights, cap):
    """Per-element scale min(1, cap/count), where count is how much batch
    weight lands on the element's destination row. ``cap`` may be a
    float (inf disables the cap) or a tensor broadcast against ``idx``."""
    cnt = _scatter_add(torch.zeros(num_rows, dtype=weights.dtype,
                                   device=weights.device), idx, weights)
    return torch.clamp(cap / torch.clamp(cnt[idx], min=1.0), max=1.0)


def _segment_sums(row_idx, updates, weights, cap):
    """Sum ``updates`` by destination row: sort by row, per-row-count
    dup_cap scale, segment sums. Returns (rows, summed, live), M entries
    each: entry j below the number of distinct rows holds the j-th of
    them (ascending) and its summed update; the others are no segment
    (``live`` False). Numerically the ``_row_mean_scale`` path up to
    summation order."""
    M = updates.shape[0]
    order = torch.sort(row_idx, stable=True).indices
    si = row_idx[order]
    su = updates[order]
    sw = weights[order]
    sc = torch.broadcast_to(torch.as_tensor(cap, dtype=updates.dtype,
                                            device=updates.device),
                            (M,))[order]
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=si.device),
                       si[1:] != si[:-1]])
    seg = torch.cumsum(start.long(), 0) - 1
    cnt = _scatter_add(torch.zeros(M, dtype=sw.dtype, device=sw.device),
                       seg, sw)
    scale = torch.clamp(sc / torch.clamp(cnt[seg], min=1.0), max=1.0)
    summed = _scatter_add(torch.zeros_like(su), seg, su * scale[:, None])
    rows = torch.zeros(M, dtype=si.dtype, device=si.device)
    rows[seg] = si                          # every member writes its row
    live = torch.arange(M, device=si.device) < start.long().sum()
    return rows, summed, live


def _add_rows(table, lo, rows, summed, live):
    """``table[rows - lo] += summed`` for the live entries whose row lies in
    the table's range [lo, lo + len(table)), in place and without a host
    sync: one ``index_add_`` of the M entries, whose rows are distinct, so
    a row takes one add of its own sum. The other entries add 0.0 to rows
    spread over the table (x + 0.0 is x, and no row takes them all). A
    row-sharded table (``nlp/distributed.py``) adds each on its owner."""
    n = table.shape[0]
    local = rows - lo
    own = live & (local >= 0) & (local < n)
    spread = torch.arange(rows.shape[0], device=rows.device) % n
    table.index_add_(0, torch.where(own, local, spread),
                     torch.where(own[:, None], summed,
                                 summed.new_zeros(())))
    return table


def _segment_row_add(row_idx, updates, weights, cap, stacked):
    """Add ``updates`` into ``stacked`` rows without a duplicate-index
    scatter (``_segment_sums``, then one add whose rows are distinct);
    returns a new ``stacked``."""
    return _add_rows(stacked.clone(), 0,
                     *_segment_sums(row_idx, updates, weights, cap))


def skipgram_step(syn0, syn1, syn1neg, centers, points, codes, code_mask,
                  neg_targets, neg_labels, lr, dup_cap, *, use_hs: bool,
                  use_ns: bool):
    """One batched skipgram update (JAX ``skipgram_step``): ``centers``
    [B] rows of syn0 move; ``points/codes/code_mask`` [B, L] the HS path;
    ``neg_targets``/``neg_labels`` [B, 1+K], positive first. Updates the
    tables in place and returns them."""
    V = syn0.shape[0]
    h = syn0[centers]
    grad_h = torch.zeros_like(h)
    if use_hs:
        w1 = syn1[points]
        f = torch.sigmoid(torch.einsum("bd,bld->bl", h, w1))
        g = (1.0 - codes - f) * code_mask * lr
        grad_h = grad_h + torch.einsum("bl,bld->bd", g, w1)
        dw1 = g[:, :, None] * h[:, None, :]
        s1 = _row_mean_scale(V, points, code_mask, dup_cap)
        _scatter_add(syn1, points, dw1 * s1[..., None])
    if use_ns:
        wn = syn1neg[neg_targets]
        f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, wn))
        g = (neg_labels - f) * lr
        grad_h = grad_h + torch.einsum("bk,bkd->bd", g, wn)
        dwn = g[:, :, None] * h[:, None, :]
        sn = _row_mean_scale(V, neg_targets,
                             torch.ones(neg_targets.shape, dtype=syn0.dtype,
                                        device=syn0.device), dup_cap)
        _scatter_add(syn1neg, neg_targets, dwn * sn[..., None])
    s0 = _row_mean_scale(V, centers, torch.ones(centers.shape,
                                                dtype=syn0.dtype,
                                                device=syn0.device), dup_cap)
    _scatter_add(syn0, centers, grad_h * s0[:, None])
    return syn0, syn1, syn1neg


def cbow_step(syn0, syn1, syn1neg, context, context_mask, points, codes,
              code_mask, neg_targets, neg_labels, lr, dup_cap, *,
              use_hs: bool, use_ns: bool):
    """One batched CBOW update (JAX ``cbow_step``): the masked context mean
    predicts the center; the input gradient is spread over the context.
    In place; returns the tables."""
    V = syn0.shape[0]
    denom = torch.clamp(context_mask.sum(1, keepdim=True), min=1.0)
    h = (syn0[context] * context_mask[..., None]).sum(1) / denom
    grad_h = torch.zeros_like(h)
    if use_hs:
        w1 = syn1[points]
        f = torch.sigmoid(torch.einsum("bd,bld->bl", h, w1))
        g = (1.0 - codes - f) * code_mask * lr
        grad_h = grad_h + torch.einsum("bl,bld->bd", g, w1)
        s1 = _row_mean_scale(V, points, code_mask, dup_cap)
        _scatter_add(syn1, points, g[:, :, None] * h[:, None, :]
                     * s1[..., None])
    if use_ns:
        wn = syn1neg[neg_targets]
        f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, wn))
        g = (neg_labels - f) * lr
        grad_h = grad_h + torch.einsum("bk,bkd->bd", g, wn)
        sn = _row_mean_scale(V, neg_targets,
                             torch.ones(neg_targets.shape, dtype=syn0.dtype,
                                        device=syn0.device), dup_cap)
        _scatter_add(syn1neg, neg_targets, g[:, :, None] * h[:, None, :]
                     * sn[..., None])
    per_ctx = (grad_h[:, None, :] * context_mask[..., None]) / denom[..., None]
    sc = _row_mean_scale(V, context, context_mask, dup_cap)
    _scatter_add(syn0, context, per_ctx * sc[..., None])
    return syn0, syn1, syn1neg


def _negative_draws(kn, S, batch, neg_k, tsize):
    """Yield the per-batch negative draws ``randint(fold_in(kn, i), (batch,
    neg_k), 0, tsize)`` for i = 0..S-1, a chunk of batches per call."""
    per = max(1, _DRAW_CHUNK // max(batch * neg_k, 1))
    for i0 in range(0, S, per):
        ids = torch.arange(i0, min(S, i0 + per), dtype=torch.int64,
                           device=kn.device)
        chunk = prandom.randint_rows(prandom.fold_in(kn, ids),
                                     (batch, neg_k), 0, tsize)
        yield from chunk


def _shifted_pairs(tokens, key, window):
    """The shifted views of the token stream: per offset d in [-W, W] \\
    {0}, the context token and whether the pair is live (same sentence,
    |d| within the position's random window, both tokens in vocab).
    Returns (ctx [N, 2W], valid [N, 2W], kn)."""
    N = tokens.shape[0]
    W = window
    kw, kn = prandom.split(key.to(tokens.device))
    win = prandom.randint(kw, (N,), 1, W + 1)
    sent_id = torch.cumsum((tokens < 0).int(), 0)
    tok_pad = torch.nn.functional.pad(tokens, (W, W), value=-1)
    sid_pad = torch.nn.functional.pad(sent_id, (W, W), value=-2)
    ctxs, valids = [], []
    for d in range(-W, W + 1):
        if d == 0:
            continue
        ctx_d = tok_pad[W + d:W + d + N]
        sid_d = sid_pad[W + d:W + d + N]
        valids.append((sid_d == sent_id) & (abs(d) <= win)
                      & (tokens >= 0) & (ctx_d >= 0))
        ctxs.append(ctx_d)
    return torch.stack(ctxs, 1), torch.stack(valids, 1), kn


def skipgram_corpus_epoch(syn0, syn1, syn1neg, tokens, key, lr_start,
                          lr_end, dup_cap, points_tab, codes_tab, cmask_tab,
                          neg_table, *, window: int, batch: int, neg_k: int,
                          use_hs: bool, use_ns: bool,
                          segment_updates: bool = False):
    """One skipgram epoch generated and trained on the tables' device (JAX
    ``skipgram_corpus_epoch``): only the token stream ``tokens`` [N] (-1
    separators and tail padding, N·2W % batch == 0) comes from the host;
    the pairs, the random window, the negatives, the HS paths and a linear
    lr_start -> lr_end ramp over the S batches are made on the device.
    Updates the tables in place (JAX donates them) and returns them."""
    ctx, val, kn = _shifted_pairs(tokens, key, window)
    N = tokens.shape[0]
    S = N * 2 * window // batch
    # rows that move = context words; predicted = centers
    rows = torch.clamp(ctx, min=0).reshape(S, batch)
    pred = torch.clamp(tokens[:, None].expand_as(ctx), min=0).reshape(S,
                                                                     batch)
    pm = val.reshape(S, batch).to(syn0.dtype)
    lrs = torch.linspace(float(lr_start), float(lr_end), S,
                         dtype=syn0.dtype, device=syn0.device)
    return _pair_scan(syn0, syn1, syn1neg, rows, pred, pm, lrs, kn,
                      points_tab, codes_tab, cmask_tab, neg_table, dup_cap,
                      dup_cap, batch=batch, neg_k=neg_k, use_hs=use_hs,
                      use_ns=use_ns, segment_updates=segment_updates)


def _apply_segments(syn0, syn1, syn1neg, parts):
    """Apply collected (row, update, weight, cap) parts, whose rows index
    the stacked [syn0; syn1; syn1neg], to the three tables in place: the
    segment sums added at the rows a batch updates, nothing else."""
    V, V1 = syn0.shape[0], syn1.shape[0]
    sums = _segment_sums(*(torch.cat(p) for p in zip(*parts)))
    for table, lo in ((syn0, 0), (syn1, V), (syn1neg, V + V1)):
        _add_rows(table, lo, *sums)


def _pair_scan(syn0, syn1, syn1neg, rows, pred, pm, lrs, kn, points_tab,
               codes_tab, cmask_tab, neg_table, dup_cap, syn0_cap, *,
               batch: int, neg_k: int, use_hs: bool, use_ns: bool,
               segment_updates: bool):
    """The skipgram family's inner loop over [S, B] (row, predicted) pair
    batches (JAX ``_pair_scan``). ``rows`` move in syn0 (skipgram: context
    words; DBOW: doc labels); ``pred`` supply the HS path / NS positive.
    ``syn0_cap`` is the dup-cap of syn0 row updates (inf for label
    training)."""
    V = syn0.shape[0]
    V1 = syn1.shape[0]
    D = syn0.shape[1]
    S = rows.shape[0]
    dt, dev = syn0.dtype, syn0.device
    dup_cap, syn0_cap = float(dup_cap), float(syn0_cap)
    draws = (_negative_draws(kn, S, batch, neg_k, neg_table.shape[0])
             if use_ns else None)
    if use_ns:
        nl = torch.zeros(batch, 1 + neg_k, dtype=dt, device=dev)
        nl[:, 0] = 1.0
    for i in range(S):
        c, p_idx, pm_b, lr = rows[i], pred[i], pm[i], lrs[i]
        h = syn0[c]
        grad_h = torch.zeros_like(h)
        parts = []
        if use_hs:
            pts = points_tab[p_idx]
            cd = codes_tab[p_idx]
            cm = cmask_tab[p_idx] * pm_b[:, None]
            w1 = syn1[pts]
            f = torch.sigmoid(torch.einsum("bd,bld->bl", h, w1))
            g = (1.0 - cd - f) * cm * lr
            grad_h = grad_h + torch.einsum("bl,bld->bd", g, w1)
            dw1 = g[:, :, None] * h[:, None, :]
            if segment_updates:
                parts.append((pts.reshape(-1) + V, dw1.reshape(-1, D),
                              cm.reshape(-1),
                              torch.full((pts.numel(),), dup_cap, dtype=dt,
                                         device=dev)))
            else:
                s1 = _row_mean_scale(V, pts, cm, dup_cap)
                _scatter_add(syn1, pts, dw1 * s1[..., None])
        if use_ns:
            nt = torch.cat([p_idx[:, None], neg_table[next(draws)]], 1)
            wn = syn1neg[nt]
            f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, wn))
            g = (nl - f) * pm_b[:, None] * lr
            grad_h = grad_h + torch.einsum("bk,bkd->bd", g, wn)
            dwn = g[:, :, None] * h[:, None, :]
            wts = pm_b[:, None].expand(nt.shape)
            if segment_updates:
                parts.append((nt.reshape(-1) + (V + V1), dwn.reshape(-1, D),
                              wts.reshape(-1),
                              torch.full((nt.numel(),), dup_cap, dtype=dt,
                                         device=dev)))
            else:
                sn = _row_mean_scale(V, nt, wts, dup_cap)
                _scatter_add(syn1neg, nt, dwn * sn[..., None])
        if segment_updates:
            parts.append((c, grad_h, pm_b,
                          torch.full((c.shape[0],), syn0_cap, dtype=dt,
                                     device=dev)))
            _apply_segments(syn0, syn1, syn1neg, parts)
        else:
            s0 = _row_mean_scale(V, c, pm_b, syn0_cap)
            _scatter_add(syn0, c, grad_h * s0[:, None])
    return syn0, syn1, syn1neg


def cbow_corpus_epoch(syn0, syn1, syn1neg, tokens, labels, key, lr_start,
                      lr_end, dup_cap, label_cap, points_tab, codes_tab,
                      cmask_tab, neg_table, *, window: int, batch: int,
                      neg_k: int, use_hs: bool, use_ns: bool,
                      with_labels: bool, segment_updates: bool = False):
    """One CBOW epoch on the device, and with ``with_labels`` one doc2vec
    DM epoch (JAX ``cbow_corpus_epoch``): every position is a center whose
    context is the 2W shifted views; ``labels`` [N] (a syn0 row per
    position, -1 = none) is prepended as an always-on context slot with
    dup-cap ``label_cap``. N % batch == 0. In place; returns the
    tables."""
    ctx, val, kn = _shifted_pairs(tokens, key, window)
    N = tokens.shape[0]
    dt, dev = syn0.dtype, syn0.device
    if with_labels:
        ctx = torch.cat([labels[:, None], ctx], 1)
        val = torch.cat([((labels >= 0) & (tokens >= 0))[:, None], val], 1)
    C = ctx.shape[1]
    S = N // batch
    V = syn0.shape[0]
    V1 = syn1.shape[0]
    D = syn0.shape[1]
    ctx_b = torch.clamp(ctx, min=0).reshape(S, batch, C)
    pm = ((tokens >= 0) & val.any(1)).to(dt)
    cm_b = (val.to(dt) * pm[:, None]).reshape(S, batch, C)
    pm_b_all = pm.reshape(S, batch)
    cen_b = torch.clamp(tokens, min=0).reshape(S, batch)
    lrs = torch.linspace(float(lr_start), float(lr_end), S, dtype=dt,
                         device=dev)
    slot_cap = torch.full((C,), float(dup_cap), dtype=dt, device=dev)
    if with_labels:
        slot_cap[0] = float(label_cap)
    draws = (_negative_draws(kn, S, batch, neg_k, neg_table.shape[0])
             if use_ns else None)
    if use_ns:
        nl = torch.zeros(batch, 1 + neg_k, dtype=dt, device=dev)
        nl[:, 0] = 1.0
    for i in range(S):
        cx, cm, p_idx, pm_b, lr = ctx_b[i], cm_b[i], cen_b[i], \
            pm_b_all[i], lrs[i]
        denom = torch.clamp(cm.sum(1, keepdim=True), min=1.0)
        h = (syn0[cx] * cm[..., None]).sum(1) / denom
        grad_h = torch.zeros_like(h)
        parts = []
        if use_hs:
            pts = points_tab[p_idx]
            cd = codes_tab[p_idx]
            hm = cmask_tab[p_idx] * pm_b[:, None]
            w1 = syn1[pts]
            f = torch.sigmoid(torch.einsum("bd,bld->bl", h, w1))
            g = (1.0 - cd - f) * hm * lr
            grad_h = grad_h + torch.einsum("bl,bld->bd", g, w1)
            dw1 = g[:, :, None] * h[:, None, :]
            if segment_updates:
                parts.append((pts.reshape(-1) + V, dw1.reshape(-1, D),
                              hm.reshape(-1),
                              torch.full((pts.numel(),), float(dup_cap),
                                         dtype=dt, device=dev)))
            else:
                s1 = _row_mean_scale(V, pts, hm, dup_cap)
                _scatter_add(syn1, pts, dw1 * s1[..., None])
        if use_ns:
            nt = torch.cat([p_idx[:, None], neg_table[next(draws)]], 1)
            wn = syn1neg[nt]
            f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, wn))
            g = (nl - f) * pm_b[:, None] * lr
            grad_h = grad_h + torch.einsum("bk,bkd->bd", g, wn)
            dwn = g[:, :, None] * h[:, None, :]
            wts = pm_b[:, None].expand(nt.shape)
            if segment_updates:
                parts.append((nt.reshape(-1) + (V + V1), dwn.reshape(-1, D),
                              wts.reshape(-1),
                              torch.full((nt.numel(),), float(dup_cap),
                                         dtype=dt, device=dev)))
            else:
                sn = _row_mean_scale(V, nt, wts, dup_cap)
                _scatter_add(syn1neg, nt, dwn * sn[..., None])
        # spread the input gradient over contributing context slots
        per_ctx = (grad_h[:, None, :] * cm[..., None]) / denom[..., None]
        cap_b = slot_cap[None, :].expand(cm.shape)
        if segment_updates:
            parts.append((cx.reshape(-1), per_ctx.reshape(-1, D),
                          cm.reshape(-1), cap_b.reshape(-1)))
            _apply_segments(syn0, syn1, syn1neg, parts)
        else:
            sc = _row_mean_scale(V, cx, cm, cap_b)
            _scatter_add(syn0, cx, per_ctx * sc[..., None])
    return syn0, syn1, syn1neg


def dbow_corpus_epoch(syn0, syn1, syn1neg, tokens, labels, key, lr_start,
                      lr_end, dup_cap, label_cap, points_tab, codes_tab,
                      cmask_tab, neg_table, *, batch: int, neg_k: int,
                      use_hs: bool, use_ns: bool,
                      segment_updates: bool = False):
    """One doc2vec DBOW epoch on the device (JAX ``dbow_corpus_epoch``):
    the skipgram inner loop with rows = ``labels`` [N] (syn0 row per
    position, -1 = none) and predicted = ``tokens``; label rows update
    with ``label_cap``. In place; returns the tables."""
    N = tokens.shape[0]
    S = N // batch
    key = key.to(tokens.device)
    _, kn = prandom.split(key)
    pm = ((tokens >= 0) & (labels >= 0)).to(syn0.dtype).reshape(S, batch)
    rows = torch.clamp(labels, min=0).reshape(S, batch)
    pred = torch.clamp(tokens, min=0).reshape(S, batch)
    lrs = torch.linspace(float(lr_start), float(lr_end), S,
                         dtype=syn0.dtype, device=syn0.device)
    return _pair_scan(syn0, syn1, syn1neg, rows, pred, pm, lrs, kn,
                      points_tab, codes_tab, cmask_tab, neg_table, dup_cap,
                      label_cap, batch=batch, neg_k=neg_k, use_hs=use_hs,
                      use_ns=use_ns, segment_updates=segment_updates)


class BatchBuilder:
    """Host-side pair/batch assembly shared by the elements learners (the
    JAX module's ``BatchBuilder``, numpy, identical): the reference's
    dynamic window (b = rand % window), subsampling, the unigram^0.75
    negative table and the [V, L] huffman path arrays
    (InMemoryLookupTable.java:55-97,120 / SkipGram.java:215-224)."""

    def __init__(self, cache, window=5, negative=0, use_hs=True,
                 sampling=0.0, table_size=None, seed=12345,
                 max_code_length=40):
        self.cache = cache
        self.window = window
        self.negative = int(negative)
        self.use_hs = use_hs
        self.sampling = sampling
        self.rng = np.random.RandomState(seed)
        self.max_code_len = max(
            (len(cache.element_at_index(i).codes)
             for i in range(cache.num_words())), default=1) or 1
        self.max_code_len = min(self.max_code_len, max_code_length)
        counts = cache.counts_array()
        if table_size is None:
            # ~32 slots per word on average (capped) so even unigram^0.75
            # tail words keep a nonzero draw probability
            table_size = int(min(max(100000, 32 * cache.num_words()),
                                 1 << 24))
        if self.negative > 0 and counts.size:
            p = counts ** 0.75
            self._neg_cum = np.cumsum(p / p.sum())
            self._neg_table = np.searchsorted(
                self._neg_cum,
                (np.arange(table_size) + 0.5) / table_size).astype(np.int32)
        else:
            self._neg_cum = None
            self._neg_table = None
        V = cache.num_words()
        L = self.max_code_len
        self.points = np.zeros((V, L), np.int32)
        self.codes = np.zeros((V, L), np.float32)
        self.code_mask = np.zeros((V, L), np.float32)
        for i in range(V):
            w = cache.element_at_index(i)
            n = min(len(w.codes), L)
            if n:
                self.points[i, :n] = w.points[:n]
                self.codes[i, :n] = w.codes[:n]
                self.code_mask[i, :n] = 1.0

    def lookup_indices(self, tokens) -> np.ndarray:
        """Vocab indices for in-vocab tokens, no subsampling."""
        idx = [self.cache.index_of(t) for t in tokens]
        return np.array([i for i in idx if i >= 0], np.int32)

    def subsample(self, idx: np.ndarray) -> np.ndarray:
        """One frequency-subsampling draw (word2vec keep probability)."""
        if self.sampling <= 0 or not idx.size:
            return idx
        counts = self.cache.counts_array()
        total = self.cache.total_word_count
        freq = counts[idx] / total
        keep_p = (np.sqrt(freq / self.sampling) + 1) * self.sampling / freq
        return idx[self.rng.random_sample(idx.size) < keep_p]

    def sentence_to_indices(self, tokens) -> np.ndarray:
        return self.subsample(self.lookup_indices(tokens))

    def pairs_from_sentence(self, idx: np.ndarray):
        """(centers, contexts) for one sentence."""
        return self.pairs_from_corpus([idx])

    def pairs_from_corpus(self, sent_indices):
        """All (center, context) pairs of a corpus in one vectorised pass,
        with the shrinking random window (b = rand % window) and sentence
        boundaries."""
        sent_indices = [s for s in sent_indices if s.size]
        if not sent_indices:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        lens = np.array([s.size for s in sent_indices])
        idx = np.concatenate(sent_indices).astype(np.int32)
        n = idx.size
        starts = np.repeat(np.cumsum(lens) - lens, lens)
        ends = starts + np.repeat(lens, lens)
        pos = np.arange(n)
        win = self.window - self.rng.randint(0, self.window, size=n)
        centers, contexts = [], []
        for d in range(-self.window, self.window + 1):
            if d == 0:
                continue
            j = pos + d
            m = (np.abs(d) <= win) & (j >= starts) & (j < ends)
            if m.any():
                centers.append(idx[m])
                contexts.append(idx[j[m]])
        if not centers:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return (np.concatenate(centers), np.concatenate(contexts))

    def sample_negatives(self, positives: np.ndarray,
                         rng: Optional[np.random.RandomState] = None
                         ) -> np.ndarray:
        """[B] -> [B, 1+K] target ids, positive first. ``rng`` overrides the
        builder's stream (deterministic inference)."""
        B, K = positives.size, self.negative
        targets = np.empty((B, 1 + K), np.int32)
        targets[:, 0] = positives
        if K:
            draws = (rng or self.rng).randint(
                0, self._neg_table.size, size=(B, K))
            targets[:, 1:] = self._neg_table[draws]
        return targets

    def neg_labels(self, B: int) -> np.ndarray:
        lab = np.zeros((B, 1 + self.negative), np.float32)
        lab[:, 0] = 1.0
        return lab

    def hs_arrays(self, predicted: np.ndarray):
        """Huffman paths for the predicted words: ([B,L] points, codes,
        mask)."""
        return (self.points[predicted], self.codes[predicted],
                self.code_mask[predicted])
