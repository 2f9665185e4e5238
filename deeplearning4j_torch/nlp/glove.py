"""GloVe: co-occurrence weighted least squares (the port of
``deeplearning4j_tpu/nlp/glove.py``; reference: models/glove/Glove.java,
GloveWeightLookupTable AdaGrad update; Pennington et al. 2014).

The co-occurrence counts accumulate in a host dict (sparse and
data-dependent); training runs on the device as AdaGrad batches over the
nonzero (i, j, X_ij) triples, cost f(X) * (w_i . w~_j + b_i + b~_j -
log X)^2 with f(x) = (x/x_max)^alpha capped at 1. Each epoch shuffles the
triples with ``permutation(fold_in(PRNGKey(seed), epoch), n)``, bitwise
JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch import resolve_device
from deeplearning4j_torch.nlp.learning import _scatter_add
from deeplearning4j_torch.nlp.sequence_vectors import host
from deeplearning4j_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_torch.nlp.vocab import VocabConstructor
from deeplearning4j_torch.ops import random as prandom


def _glove_epoch(W, Wc, b, bc, hW, hWc, hb, hbc, wi, wj, logx, fx, key,
                 lr, eps, *, batch: int):
    """One epoch (JAX ``_glove_epoch``): shuffle the triples with the
    device PRNG, then AdaGrad batches in order; padding triples carry fx=0
    and contribute nothing. Updates the eight tables in place and returns
    them."""
    n = wi.shape[0]
    perm = prandom.permutation(key, n)
    nb = n // batch

    def gather(a):
        return a[perm].reshape(nb, batch, *a.shape[1:])

    xs = (gather(wi), gather(wj), gather(logx), gather(fx))
    carry = (W, Wc, b, bc, hW, hWc, hb, hbc)
    for i in range(nb):
        _glove_batch(*carry, xs[0][i], xs[1][i], xs[2][i], xs[3][i], lr, eps)
    return carry


def _glove_batch(W, Wc, b, bc, hW, hWc, hb, hbc, wi, wj, logx, fx, lr, eps):
    """One AdaGrad batch over triples (wi, wj, X) (JAX ``_glove_batch``),
    in place."""
    vi = W[wi]
    vj = Wc[wj]
    diff = torch.einsum("bd,bd->b", vi, vj) + b[wi] + bc[wj] - logx
    g = fx * diff
    gi = g[:, None] * vj
    gj = g[:, None] * vi
    gb = g
    # AdaGrad accumulators, then the steps over the updated accumulators
    _scatter_add(hW, wi, gi * gi)
    _scatter_add(hWc, wj, gj * gj)
    _scatter_add(hb, wi, gb * gb)
    _scatter_add(hbc, wj, gb * gb)
    _scatter_add(W, wi, -lr * gi / torch.sqrt(hW[wi] + eps))
    _scatter_add(Wc, wj, -lr * gj / torch.sqrt(hWc[wj] + eps))
    _scatter_add(b, wi, -lr * gb / torch.sqrt(hb[wi] + eps))
    _scatter_add(bc, wj, -lr * gb / torch.sqrt(hbc[wj] + eps))
    return W, Wc, b, bc, hW, hWc, hb, hbc


class Glove:
    def __init__(self, layer_size: int = 100, window: int = 15,
                 min_word_frequency: int = 1, epochs: int = 25,
                 learning_rate: float = 0.05, x_max: float = 100.0,
                 alpha: float = 0.75, batch_size: int = 4096,
                 symmetric: bool = True, seed: int = 12345,
                 tokenizer_factory=None, device=None):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.symmetric = symmetric
        self.seed = seed
        self.tokenizer_factory = tokenizer_factory or \
            DefaultTokenizerFactory()
        self.device = device
        self.vocab = None
        self.syn0 = None

    def _cooccurrences(self, sentences) -> dict:
        """Distance-weighted co-occurrence counts (reference:
        glove/count/CoOccurrenceCounter; weight 1/d)."""
        counts: dict = {}
        for sentence in sentences:
            toks = self.tokenizer_factory.create(sentence).tokens() \
                if isinstance(sentence, str) else list(sentence)
            idx = [self.vocab.index_of(t) for t in toks]
            idx = [i for i in idx if i >= 0]
            for i, wi in enumerate(idx):
                for d in range(1, self.window + 1):
                    j = i + d
                    if j >= len(idx):
                        break
                    wj = idx[j]
                    w = 1.0 / d
                    counts[(wi, wj)] = counts.get((wi, wj), 0.0) + w
                    if self.symmetric:
                        counts[(wj, wi)] = counts.get((wj, wi), 0.0) + w
        return counts

    def init_tables(self, V: int):
        """The eight training tables on the device, drawn as the JAX
        package draws them (``RandomState(seed)``, U(-0.5/D, 0.5/D))."""
        dev = resolve_device(self.device)
        D = self.layer_size
        rng = np.random.RandomState(self.seed)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        W = t((rng.random_sample((V, D)) - 0.5) / D)
        Wc = t((rng.random_sample((V, D)) - 0.5) / D)
        return (W, Wc, t(np.zeros(V)), t(np.zeros(V)),
                t(np.full((V, D), 1e-8)), t(np.full((V, D), 1e-8)),
                t(np.full(V, 1e-8)), t(np.full(V, 1e-8)))

    def triples(self, cooc: dict, dev):
        """(wi, wj, log X, f(X)) on ``dev``, padded with fx=0 triples to a
        whole number of batches, and the batch size."""
        keys = np.array(list(cooc.keys()), np.int32)
        vals = np.array(list(cooc.values()), np.float32)
        logx = np.log(vals)
        fx = np.minimum((vals / self.x_max) ** self.alpha, 1.0) \
            .astype(np.float32)
        n = keys.shape[0]
        B = min(self.batch_size, n)
        pad = (-n) % B

        def t(a, fill_dtype):
            return torch.as_tensor(np.concatenate(
                [a, np.zeros(pad, fill_dtype)])).to(dev)

        return (t(keys[:, 0], np.int32).long(), t(keys[:, 1], np.int32).long(),
                t(logx, np.float32), t(fx, np.float32), B)

    def fit(self, sentences) -> "Glove":
        dev = resolve_device(self.device)
        if self.vocab is None:
            self.vocab = VocabConstructor(
                min_word_frequency=self.min_word_frequency,
                tokenizer_factory=self.tokenizer_factory,
                build_huffman=False).build_vocab(
                    s if isinstance(s, str) else " ".join(s)
                    for s in sentences)
        if hasattr(sentences, "reset"):
            sentences.reset()
        cooc = self._cooccurrences(sentences)
        if not cooc:
            raise ValueError("Empty co-occurrence matrix")
        tables = self.init_tables(self.vocab.num_words())
        wi, wj, logx, fx, B = self.triples(cooc, dev)
        base = prandom.PRNGKey(self.seed, device=dev)
        for e in range(self.epochs):
            tables = _glove_epoch(*tables, wi, wj, logx, fx,
                                  prandom.fold_in(base, e),
                                  self.learning_rate, 1e-8, batch=B)
        # final embedding = W + Wc (standard GloVe practice)
        self.syn0 = tables[0] + tables[1]
        return self

    # --------------------------------------------------------------- queries
    def word_vector(self, word):
        i = self.vocab.index_of(word)
        return None if i < 0 else host(self.syn0[i])

    def similarity(self, a: str, b: str) -> float:
        ia, ib = self.vocab.index_of(a), self.vocab.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        va, vb = host(self.syn0[ia]), host(self.syn0[ib])
        return float(np.dot(va, vb) /
                     max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-12))
