"""ParagraphVectors / doc2vec (the port of
``deeplearning4j_tpu/nlp/paragraph_vectors.py``; reference:
models/paragraphvectors/ParagraphVectors.java:47, sequence learning impls
DBOW.java + DM.java).

Labels live in the same lookup table as words: each label gets a vocab
entry and a syn0 row. DBOW: the label row predicts each word of its
document through the word's HS path / negatives. DM: the label is
prepended to every CBOW context window. Plain negative-sampling DBOW and DM
without ``train_words`` train in the native C loops under
``backend="native"``, and under ``"auto"`` when the tables live on the
host, as the JAX package routes them there.

``infer_vector`` trains a fresh row against frozen syn1/syn1neg on the
device (reference: ParagraphVectors.inferVector).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.nlp.sequence_vectors import (SequenceVectors, host,
                                                       on_device)
from deeplearning4j_torch.nlp.vocab import Huffman, VocabWord
from deeplearning4j_torch.ops import random as prandom


def _infer_step(vec, syn1, syn1neg, points, codes, code_mask, neg_targets,
                neg_labels, lr, *, use_hs: bool, use_ns: bool):
    """DBOW inference: move only ``vec`` [D]; syn1/syn1neg frozen (JAX
    ``_infer_step``). Returns the new vector."""
    grad = torch.zeros_like(vec)
    if use_hs:
        w1 = syn1[points]
        f = torch.sigmoid(torch.einsum("d,bld->bl", vec, w1))
        g = (1.0 - codes - f) * code_mask * lr
        grad = grad + torch.einsum("bl,bld->d", g, w1)
    if use_ns:
        wn = syn1neg[neg_targets]
        f = torch.sigmoid(torch.einsum("d,bkd->bk", vec, wn))
        g = (neg_labels - f) * lr
        grad = grad + torch.einsum("bk,bkd->d", g, wn)
    return vec + grad


class ParagraphVectors(SequenceVectors):
    """reference: ParagraphVectors.java:47 (builder + inferVector)."""

    LABEL_PREFIX = "__label__"

    def __init__(self, sequence_algorithm: str = "dbow",
                 train_words: bool = False, **kw):
        kw.setdefault("elements_algorithm", "skipgram")
        # doc2vec batches stay small: every position of a document carries
        # the same label row (the JAX package's default and reason)
        kw.setdefault("batch_size", 64)
        super().__init__(**kw)
        self.sequence_algorithm = sequence_algorithm.lower()
        self.train_words = train_words
        self._label_ids: dict = {}

    # --------------------------------------------------------------- native
    def _native_eligible_config(self) -> bool:
        """The native kernels cover plain-NS DBOW and DM without word
        co-training; hierarchic softmax, subsampling and train_words keep
        the device path."""
        from deeplearning4j_torch.native import (NATIVE_MAX_WINDOW,
                                                 cbow_native_available,
                                                 pairs_native_available)

        if not (self._native_common_eligible()
                and not self.train_words):
            return False
        if self.sequence_algorithm == "dbow":
            return pairs_native_available()
        return (self.sequence_algorithm == "dm"
                and 1 <= self.window <= NATIVE_MAX_WINDOW
                and cbow_native_available())

    def _fit_native_docs(self, entries) -> bool:
        """Train documents in the native kernels: DBOW as label->word NS
        pairs, DM as CBOW windows with the label row in every context.
        Returns False when the native library is unavailable (the caller
        takes the device path with the same entries)."""
        from deeplearning4j_torch import native

        syn0, syn1neg, table = self._native_tables()
        common = dict(negative=self.negative, alpha=self.learning_rate,
                      min_alpha=self.min_learning_rate,
                      epochs=self.epochs * self.iterations,
                      seed=self.seed or 1)
        if self.sequence_algorithm == "dbow":
            rows = np.concatenate(
                [np.full(idx.size, label_row, np.int32)
                 for idx, label_row in entries])
            targets = np.concatenate(
                [np.asarray(idx, np.int32) for idx, _ in entries])
            out = native.ns_pairs_train(syn0, syn1neg, rows, targets, table,
                                        **common)
        else:  # dm
            sep = np.asarray([-1], np.int32)
            corpus = np.concatenate(
                [np.concatenate([np.asarray(idx, np.int32), sep])
                 for idx, _ in entries])
            labels = np.concatenate(
                [np.concatenate([np.full(idx.size, label_row, np.int32),
                                 sep])
                 for idx, label_row in entries])
            out = native.cbow_train(syn0, syn1neg, corpus, table,
                                    window=self.window, labels=labels,
                                    **common)
        if out is None:
            return False
        _, self.syn0, self.syn1neg = out
        return True

    # ------------------------------------------------------------------ vocab
    def _label_token(self, label: str) -> str:
        return self.LABEL_PREFIX + label

    def build_vocab_from_documents(self, documents) -> None:
        contents = [d.content for d in documents]
        self.build_vocab(contents)
        # labels join the vocab (no huffman path needed: they are never
        # predicted), then indices and tree are rebuilt
        for d in documents:
            for label in d.labels:
                t = self._label_token(label)
                if not self.vocab.contains_word(t):
                    self.vocab.add_token(VocabWord(t, 1.0))
        self.vocab.update_indices()
        Huffman(self.vocab).build()

    # -------------------------------------------------------------------- fit
    def fit(self, documents) -> "ParagraphVectors":
        """Device-resident doc2vec: the host uploads a token stream plus a
        parallel label stream (syn0 row id per position) and each pass runs
        on the device. Label syn0 updates run with dup_cap=inf; multi-label
        documents repeat their tokens once per label."""
        from deeplearning4j_torch.nlp.learning import (DUP_CAP,
                                                       cbow_corpus_epoch,
                                                       dbow_corpus_epoch,
                                                       skipgram_corpus_epoch)

        if self.sequence_algorithm not in ("dbow", "dm"):
            raise ValueError(
                f"Unknown sequence algorithm '{self.sequence_algorithm}'")
        documents = list(documents)
        if self.vocab is None:
            self.build_vocab_from_documents(documents)
        if self.syn0 is None:
            self.reset_weights()
        self._label_ids = {
            label: self.vocab.index_of(self._label_token(label))
            for d in documents for label in d.labels}
        b = self._builder
        entries, total_tokens = [], 0
        for d in documents:
            tokens = self.tokenizer_factory.create(d.content).tokens()
            idx = b.lookup_indices(tokens)
            if idx.size == 0:
                continue
            for label in d.labels:
                entries.append((idx, self._label_ids[label]))
                total_tokens += idx.size
        if not entries:
            return self
        if self._use_native_backend() and self._fit_native_docs(entries):
            return self
        dev = self._device_tables()
        B, W, K = self.batch_size, self.window, self.negative
        points_tab, codes_tab, cmask_tab, neg_table = \
            self._lookup_tables(dev)
        total_units = max(total_tokens * self.epochs * self.iterations, 1)
        done = 0

        def on_dev(a):
            return None if a is None else torch.as_tensor(a).long().to(dev)

        # without subsampling every pass trains on identical streams
        static_streams = None if self.sampling > 0 else \
            tuple(map(on_dev, self._doc_streams(entries, B, W)))
        static_words = None
        if self.sampling <= 0 and self.train_words:
            static_words = on_dev(self._token_stream(
                [idx for idx, _ in entries], B, W))
        base = prandom.PRNGKey(self.seed + 7, device=dev)
        inf = float("inf")
        for e in range(self.epochs):
            for it in range(self.iterations):
                if self.sampling > 0:
                    ent = [(b.subsample(idx), lab) for idx, lab in entries]
                    toks, labs = map(on_dev, self._doc_streams(ent, B, W))
                    words_stream = (on_dev(self._token_stream(
                        [idx for idx, _ in ent], B, W))
                        if self.train_words else None)
                else:
                    toks, labs = static_streams
                    words_stream = static_words
                lr0 = self._alpha(min(done / total_units, 1.0))
                lr1 = self._alpha(min((done + total_tokens) / total_units,
                                      1.0))
                key = prandom.fold_in(base, done + e * 131071 + it)
                done += total_tokens
                if toks is None:
                    continue
                if self.sequence_algorithm == "dbow":
                    dbow_corpus_epoch(
                        self.syn0, self.syn1, self.syn1neg, toks, labs, key,
                        lr0, lr1, DUP_CAP, inf, points_tab, codes_tab,
                        cmask_tab, neg_table, batch=B, neg_k=max(K, 0),
                        use_hs=self.use_hs, use_ns=K > 0)
                else:
                    cbow_corpus_epoch(
                        self.syn0, self.syn1, self.syn1neg, toks, labs, key,
                        lr0, lr1, DUP_CAP, inf, points_tab, codes_tab,
                        cmask_tab, neg_table, window=W, batch=B,
                        neg_k=max(K, 0), use_hs=self.use_hs, use_ns=K > 0,
                        with_labels=True)
                if self.train_words and words_stream is not None:
                    # trainWords=true: ordinary skipgram over the corpus
                    skipgram_corpus_epoch(
                        self.syn0, self.syn1, self.syn1neg, words_stream,
                        prandom.fold_in(key, 1), lr0, lr1, DUP_CAP,
                        points_tab, codes_tab, cmask_tab, neg_table,
                        window=W, batch=B, neg_k=max(K, 0),
                        use_hs=self.use_hs, use_ns=K > 0)
        return self

    @classmethod
    def _doc_streams(cls, entries, batch: int, window: int):
        """Parallel (token, label-row) int32 host streams with -1
        separators, padded to the 'positions' bucket (N % batch == 0)."""
        tparts, lparts = [], []
        for idx, lab in entries:
            if idx.size:
                tparts.append(idx.astype(np.int32))
                tparts.append(np.full(1, -1, np.int32))
                lparts.append(np.full(idx.size, lab, np.int32))
                lparts.append(np.full(1, -1, np.int32))
        if not tparts:
            return None, None
        t = np.concatenate(tparts)
        lab = np.concatenate(lparts)
        n = cls._bucket_size(t.size, batch, window, "positions")
        pad = np.full(n - t.size, -1, np.int32)
        return np.concatenate([t, pad]), np.concatenate([lab, pad])

    # ------------------------------------------------------------- inference
    def infer_vector(self, text: str, learning_rate: float = 0.01,
                     iterations: int = 5, seed: int = 0) -> np.ndarray:
        """Train a fresh paragraph vector for unseen text on the device
        (reference: ParagraphVectors.inferVector); the start vector and the
        negatives come from numpy streams seeded with ``seed``, as in the
        JAX package. A native run's host tables stay on the host."""
        dev = self._dev()
        syn1, syn1neg = on_device(self.syn1, dev), on_device(self.syn1neg,
                                                             dev)
        tokens = self.tokenizer_factory.create(text).tokens()
        idx = self._builder.sentence_to_indices(tokens)
        rng = np.random.RandomState(seed)
        vec = torch.as_tensor(
            ((rng.random_sample(self.layer_size) - 0.5)
             / self.layer_size).astype(np.float32)).to(dev)
        if idx.size == 0:
            return host(vec)
        b = self._builder
        points, codes, mask = (torch.as_tensor(a).to(dev)
                               for a in b.hs_arrays(idx))
        points = points.long()
        labels = torch.as_tensor(b.neg_labels(idx.size)).to(dev)
        neg_rng = np.random.RandomState(seed + 1)
        for _ in range(iterations):
            negs = torch.as_tensor(b.sample_negatives(idx, rng=neg_rng)
                                   ).long().to(dev)
            vec = _infer_step(vec, syn1, syn1neg, points, codes,
                              mask, negs, labels, learning_rate,
                              use_hs=self.use_hs, use_ns=self.negative > 0)
        return host(vec)

    # ------------------------------------------------------------- query API
    def labels(self) -> list:
        return list(self._label_ids)

    def label_vector(self, label: str) -> np.ndarray:
        return host(self.syn0[self._label_ids[label]])

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.label_vector(label)
        denom = max(np.linalg.norm(v) * np.linalg.norm(lv), 1e-12)
        return float(np.dot(v, lv) / denom)

    def predict(self, text: str) -> str:
        """Nearest label for unseen text (reference:
        ParagraphVectors.predict)."""
        v = self.infer_vector(text)
        best, best_sim = None, -2.0
        for label in self._label_ids:
            lv = self.label_vector(label)
            denom = max(np.linalg.norm(v) * np.linalg.norm(lv), 1e-12)
            sim = float(np.dot(v, lv) / denom)
            if sim > best_sim:
                best, best_sim = label, sim
        return best
