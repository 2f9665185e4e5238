"""SequenceVectors: the generic embedding trainer engine (the port of
``deeplearning4j_tpu/nlp/sequence_vectors.py``).

Reference: models/sequencevectors/SequenceVectors.java:187-216 (fit: build
vocab -> reset weights -> train), :336-356 (the elements learners).

Sentences are tokenized on the host; the host uploads one token stream per
corpus block and the whole block trains on the device
(``nlp/learning.py``). Linear LR decay matches the reference (alpha * (1 -
progress), floored at min_learning_rate). Negative-sampling skip-gram and
CBOW without hierarchic softmax or subsampling train in the native C loop
(``native/skipgram.c``) under ``backend="native"``, and under
``backend="auto"`` when the tables live on the host, as the JAX package
routes them there; on a card ``"auto"`` trains them on the device.

The tables live on ``device`` (CUDA unless the caller passes another); a
native run trains host copies and keeps them on the host, as the JAX
package does. Word queries (similarity, words_nearest) normalise syn0 on
the device and rank with one [V, D] @ [D] product there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.nlp.distributed import RowShardedTable
from deeplearning4j_torch.nlp.learning import (
    DUP_CAP,
    BatchBuilder,
    cbow_corpus_epoch,
    skipgram_corpus_epoch,
)
from deeplearning4j_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_torch.nlp.vocab import AbstractCache, VocabConstructor
from deeplearning4j_torch.ops import random as prandom


def host(a) -> np.ndarray:
    """A table as a host array (a tensor is fetched from its device)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def on_device(a, dev: torch.device) -> torch.Tensor:
    """A table as a tensor on ``dev`` (a host array or a tensor elsewhere
    is copied there)."""
    if (torch.is_tensor(a) and a.device == dev) or isinstance(
            a, RowShardedTable):
        return a
    return torch.as_tensor(host(a)).to(dev)


class SequenceVectors:
    """Configurable embedding trainer (reference builder fields map to
    keyword arguments of the same meaning, as in the JAX package);
    ``device`` is where the tables train and the queries run."""

    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_word_frequency: int = 1, epochs: int = 1,
                 iterations: int = 1, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, negative: int = 0,
                 use_hierarchic_softmax: bool = True, sampling: float = 0.0,
                 batch_size: int = 512, seed: int = 12345,
                 elements_algorithm: str = "skipgram",
                 tokenizer_factory=None, backend: str = "auto",
                 device=None):
        if backend not in ("auto", "device", "native"):
            raise ValueError(f"Unknown backend '{backend}'")
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.iterations = iterations
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        if not use_hierarchic_softmax and negative <= 0:
            raise ValueError("Need hierarchical softmax and/or negative>0")
        self.sampling = sampling
        self.batch_size = batch_size
        self.seed = seed
        self.elements_algorithm = elements_algorithm.lower()
        self.tokenizer_factory = tokenizer_factory or \
            DefaultTokenizerFactory()
        self.backend = backend
        self.device = device
        self.vocab: Optional[AbstractCache] = None
        self.syn0 = None
        self.syn1 = None
        self.syn1neg = None
        self._builder: Optional[BatchBuilder] = None

    def _dev(self) -> torch.device:
        """The tables' device: CUDA unless the caller asked for another."""
        return resolve_device(self.device)

    # ------------------------------------------------------------------ vocab
    def build_vocab(self, sentences) -> None:
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            tokenizer_factory=self.tokenizer_factory,
            build_huffman=True).build_vocab(sentences)

    def reset_weights(self) -> None:
        """syn0 ~ U(-0.5/D, 0.5/D), syn1/syn1neg zeros (reference:
        InMemoryLookupTable.resetWeights). The tables start on the host
        when the native backend will train them, on the device
        otherwise."""
        dev = self._dev()
        V, D = self.vocab.num_words(), self.layer_size
        rng = np.random.RandomState(self.seed)
        syn0 = ((rng.random_sample((V, D)) - 0.5) / D).astype(np.float32)
        if self._native_route():
            self.syn0 = syn0
            self.syn1 = np.zeros((V, D), np.float32)
            self.syn1neg = np.zeros((V, D), np.float32)
        else:
            self.syn0 = torch.from_numpy(syn0).to(dev)
            self.syn1 = torch.zeros(V, D, dtype=torch.float32, device=dev)
            self.syn1neg = torch.zeros(V, D, dtype=torch.float32, device=dev)
        self._builder = BatchBuilder(
            self.vocab, window=self.window, negative=self.negative,
            use_hs=self.use_hs, sampling=self.sampling, seed=self.seed)

    def _device_tables(self):
        """Move host tables (a native run's, or a native fallback's) to the
        device; returns it."""
        dev = self._dev()
        for name in ("syn0", "syn1", "syn1neg"):
            setattr(self, name, on_device(getattr(self, name), dev))
        return dev

    # -------------------------------------------------------------------- fit
    def fit(self, sentences) -> "SequenceVectors":
        """Build vocab (if absent) and train (reference: fit :187-216)."""
        if self.vocab is None:
            self.build_vocab(sentences)
        if self.syn0 is None:
            self.reset_weights()
        if self.elements_algorithm not in ("skipgram", "cbow"):
            raise ValueError("Unknown elements algorithm "
                             f"'{self.elements_algorithm}'")
        if self._use_native_backend():
            return self._fit_native(sentences)
        return self._fit_element_epochs(sentences)

    def _native_route(self) -> bool:
        """Whether fit trains in the native C loop: an eligible config
        (plain negative-sampling skip-gram/CBOW; the device path keeps
        hierarchic softmax and subsampling) under ``backend="native"``, or
        under ``"auto"`` with the tables on the host (the JAX package's
        rule there). On a card ``"auto"`` keeps the tables on it."""
        if isinstance(self.syn0, RowShardedTable):
            return False            # sharded tables train on the device
        return self._native_eligible_config() and (
            self.backend == "native" or self._dev().type == "cpu")

    def _use_native_backend(self) -> bool:
        """``_native_route``, refusing ``backend="native"`` for a config
        the C loop cannot train."""
        if self.backend == "native":
            if not self._native_eligible_config():
                raise ValueError(
                    "backend='native' requires a config the native "
                    "kernels support — negative-sampling skip-gram/CBOW "
                    "(Word2Vec) or DBOW / DM without train_words "
                    "(ParagraphVectors); no HS, no subsampling — and the "
                    "C toolchain")
        return self._native_route()

    def _native_common_eligible(self) -> bool:
        """Conditions shared by every native kernel (layer_size within the
        C accumulator, no HS, negatives, no subsampling, a built
        library)."""
        from deeplearning4j_torch.native import (NATIVE_MAX_LAYER,
                                                 skipgram_native_available)

        return (self.backend != "device"
                and not self.use_hs and self.negative > 0
                and self.sampling == 0.0
                and self.layer_size <= NATIVE_MAX_LAYER
                and skipgram_native_available())

    def _native_eligible_config(self) -> bool:
        """Config-level native-backend eligibility (the per-kernel probes
        guard against a library missing the newer symbols)."""
        from deeplearning4j_torch.native import (NATIVE_MAX_WINDOW,
                                                 cbow_native_available)

        if not (self._native_common_eligible() and self.window >= 1):
            return False
        if self.elements_algorithm == "skipgram":
            return True
        return (self.elements_algorithm == "cbow"
                and self.window <= NATIVE_MAX_WINDOW
                and cbow_native_available())

    def _native_tables(self):
        """(syn0, syn1neg, unigram^0.75 table) as host arrays for the C
        kernels; device tables are fetched once."""
        counts = self.vocab.counts_array()
        p = counts ** 0.75
        p /= p.sum()
        table = np.repeat(np.arange(len(p), dtype=np.int32),
                          np.maximum(1, (p * 1_000_000).astype(np.int64)))
        syn0 = np.ascontiguousarray(host(self.syn0), np.float32)
        syn1neg = np.ascontiguousarray(host(self.syn1neg), np.float32)
        return syn0, syn1neg, table

    def _fit_native(self, sentences) -> "SequenceVectors":
        """Train via native/skipgram.c (skip-gram or CBOW)."""
        from deeplearning4j_torch import native

        if hasattr(sentences, "reset"):
            sentences.reset()
        cache = self.vocab
        corpus = []
        for sentence in sentences:
            tokens = self.tokenizer_factory.create(sentence).tokens() \
                if isinstance(sentence, str) else list(sentence)
            any_tok = False
            for tok in tokens:
                i = cache.index_of(tok)
                if i >= 0:
                    corpus.append(i)
                    any_tok = True
            if any_tok:
                corpus.append(-1)
        if not corpus:
            return self
        syn0, syn1neg, table = self._native_tables()
        kernel = (native.skipgram_train
                  if self.elements_algorithm == "skipgram"
                  else native.cbow_train)
        out = kernel(
            syn0, syn1neg, np.asarray(corpus, np.int32), table,
            window=self.window, negative=self.negative,
            alpha=self.learning_rate, min_alpha=self.min_learning_rate,
            epochs=self.epochs * self.iterations, seed=self.seed or 1)
        if out is None:  # the library went away: device fallback
            # ``sentences`` may be a one-shot generator the corpus walk
            # above consumed: train on the materialized index corpus
            rebuilt, cur = [], []
            for i in corpus:
                if i < 0:
                    rebuilt.append(cur)
                    cur = []
                else:
                    cur.append(cache.word_at_index(i))
            if cur:
                rebuilt.append(cur)
            return self._fit_element_epochs(rebuilt)
        _, self.syn0, self.syn1neg = out
        return self

    def _lookup_tables(self, dev):
        """The HS path tables and the negative table on ``dev`` (int64
        indices), uploaded once per fit."""
        b = self._builder
        if self.use_hs:
            points = torch.as_tensor(b.points).long().to(dev)
            codes = torch.as_tensor(b.codes).to(dev)
            cmask = torch.as_tensor(b.code_mask).to(dev)
        else:
            points = torch.zeros(1, 1, dtype=torch.int64, device=dev)
            codes = torch.zeros(1, 1, dtype=torch.float32, device=dev)
            cmask = torch.zeros(1, 1, dtype=torch.float32, device=dev)
        neg = (torch.as_tensor(b._neg_table).long().to(dev)
               if self.negative > 0
               else torch.zeros(1, dtype=torch.int64, device=dev))
        return points, codes, cmask, neg

    def _fit_element_epochs(self, sentences) -> "SequenceVectors":
        """Device-resident skipgram/CBOW training: the host uploads only
        the token stream of each corpus block (-1 sentence separators);
        pair generation, negative sampling, huffman-path gathers and the
        batched updates run on the device (``skipgram_corpus_epoch``).
        Blocks of ~BLOCK_TOKENS; streams padded to the buckets of
        ``_bucket_size``; LR decays linearly over the whole run."""
        dev = self._device_tables()
        b = self._builder
        if hasattr(sentences, "reset"):
            sentences.reset()
        BLOCK_TOKENS = 1 << 21
        blocks, cur, cur_tokens, total_tokens = [], [], 0, 0
        for sentence in sentences:
            tokens = self.tokenizer_factory.create(sentence).tokens() \
                if isinstance(sentence, str) else list(sentence)
            idx = b.lookup_indices(tokens)
            if idx.size == 0:
                continue
            cur.append(idx)
            cur_tokens += idx.size
            total_tokens += idx.size
            if cur_tokens >= BLOCK_TOKENS:
                blocks.append(cur)
                cur, cur_tokens = [], 0
        if cur:
            blocks.append(cur)
        if not blocks:
            return self
        B, W, K = self.batch_size, self.window, self.negative
        points_tab, codes_tab, cmask_tab, neg_table = \
            self._lookup_tables(dev)
        total_units = max(total_tokens * self.epochs * self.iterations, 1)
        done = 0
        base = prandom.PRNGKey(self.seed + 1, device=dev)
        for e in range(self.epochs):
            for block in blocks:
                for it in range(self.iterations):
                    # fresh subsampling draw per pass; dynamic windows are
                    # drawn on the device from the per-call key
                    sent_idx = [b.subsample(sid) for sid in block] \
                        if self.sampling > 0 else block
                    mode = ("pairs" if self.elements_algorithm == "skipgram"
                            else "positions")
                    stream = self._token_stream(sent_idx, B, W, mode=mode)
                    if stream is None:
                        continue
                    stream = torch.as_tensor(stream).long().to(dev)
                    raw = sum(sid.size for sid in block)
                    lr0 = self._alpha(min(done / total_units, 1.0))
                    lr1 = self._alpha(min((done + raw) / total_units, 1.0))
                    key = prandom.fold_in(base, done + e * 131071 + it)
                    if self.elements_algorithm == "skipgram":
                        skipgram_corpus_epoch(
                            self.syn0, self.syn1, self.syn1neg, stream, key,
                            lr0, lr1, DUP_CAP, points_tab, codes_tab,
                            cmask_tab, neg_table, window=W, batch=B,
                            neg_k=max(K, 0), use_hs=self.use_hs,
                            use_ns=K > 0)
                    else:
                        cbow_corpus_epoch(
                            self.syn0, self.syn1, self.syn1neg, stream,
                            stream, key, lr0, lr1, DUP_CAP, DUP_CAP,
                            points_tab, codes_tab, cmask_tab, neg_table,
                            window=W, batch=B, neg_k=max(K, 0),
                            use_hs=self.use_hs, use_ns=K > 0,
                            with_labels=False)
                    done += raw
        return self

    # Above this size, stream shapes snap to multiples of it instead of
    # powers of two (bounded padding waste, bounded shape count)
    _STREAM_QUANTUM = 1 << 17

    @classmethod
    def _bucket_size(cls, size: int, batch: int, window: int,
                     mode: str) -> int:
        """Bucketed stream length N (the JAX package's): powers of two below
        _STREAM_QUANTUM, multiples of it above. mode 'pairs' (skipgram)
        needs N*2W % batch == 0; 'positions' (CBOW/DBOW) N % batch == 0."""
        def ok(n):
            return ((n * 2 * window) % batch == 0 if mode == "pairs"
                    else n % batch == 0)

        q = cls._STREAM_QUANTUM
        if size <= q:
            n = max(int(batch), 2)
            while n < size or not ok(n):
                n *= 2
        else:
            n = ((size + q - 1) // q) * q
            while not ok(n):
                n += q
        return n

    @classmethod
    def _token_stream(cls, sent_idx, batch: int, window: int,
                      mode: str = "pairs") -> Optional[np.ndarray]:
        """Concatenate sentences with -1 separators, pad with -1 to the
        bucketed length: an int32 host array, or None when empty."""
        parts = []
        for sid in sent_idx:
            if sid.size:
                parts.append(sid.astype(np.int32))
                parts.append(np.full(1, -1, np.int32))
        if not parts:
            return None
        stream = np.concatenate(parts)
        n = cls._bucket_size(stream.size, batch, window, mode)
        return np.concatenate([stream, np.full(n - stream.size, -1,
                                               np.int32)])

    def _alpha(self, progress: float) -> float:
        return max(self.min_learning_rate,
                   self.learning_rate * (1.0 - progress))

    # ------------------------------------------------------------ query API
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else host(self.syn0[i])

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def _norm_syn0(self) -> torch.Tensor:
        """syn0's vocabulary rows, each over its norm, on the device."""
        s = on_device(self.syn0, self._dev())[:self.vocab.num_words()]
        return s / torch.clamp(torch.linalg.vector_norm(s, dim=1,
                                                        keepdim=True),
                               min=1e-12)

    def similarity(self, a: str, b: str) -> float:
        """Cosine similarity (reference: WordVectorsImpl.similarity)."""
        ia, ib = self.vocab.index_of(a), self.vocab.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        s = self._norm_syn0()
        return float(torch.dot(s[ia], s[ib]))

    def _ranked(self, s, v, exclude, top_n):
        """The ``top_n`` rows of ``s @ v`` outside ``exclude``, best
        first."""
        sims = s @ v
        k = min(top_n + len(exclude), sims.shape[0])
        vals, order = torch.sort(-sims, stable=True)
        vals, order = (-vals[:k]).tolist(), order[:k].tolist()
        out = []
        for j, sim in zip(order, vals):
            if j in exclude:
                continue
            out.append((self.vocab.word_at_index(j), float(sim)))
            if len(out) >= top_n:
                break
        return out

    def words_nearest(self, word_or_vec, top_n: int = 10) -> list:
        """Top-N cosine neighbours (reference: wordsNearest)."""
        s = self._norm_syn0()
        if isinstance(word_or_vec, str):
            i = self.vocab.index_of(word_or_vec)
            if i < 0:
                return []
            vec = torch.as_tensor(host(self.syn0[i])).to(s.device)
            exclude = {i}
        else:
            vec = torch.as_tensor(np.asarray(word_or_vec, np.float32)).to(
                s.device)
            exclude = set()
        v = vec / max(float(torch.linalg.vector_norm(vec)), 1e-12)
        return self._ranked(s, v, exclude, top_n)

    def words_nearest_sum(self, positive: list, negative: list,
                          top_n: int = 10) -> list:
        """king - man + woman style analogy (reference: wordsNearestSum)."""
        s = self._norm_syn0()
        vec = torch.zeros(self.layer_size, dtype=torch.float64,
                          device=s.device)
        exclude = set()
        for w in positive:
            i = self.vocab.index_of(w)
            if i >= 0:
                vec += s[i]
                exclude.add(i)
        for w in negative:
            i = self.vocab.index_of(w)
            if i >= 0:
                vec -= s[i]
                exclude.add(i)
        v = vec / max(float(torch.linalg.vector_norm(vec)), 1e-12)
        return self._ranked(s.double(), v, exclude, top_n)
