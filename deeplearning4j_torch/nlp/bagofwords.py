"""Bag-of-words / TF-IDF vectorizers, host numpy (the port's own copy of
``deeplearning4j_tpu/nlp/bagofwords.py``; reference: bagofwords/vectorizer/ —
BagOfWordsVectorizer, TfidfVectorizer over an inverted index)."""

from __future__ import annotations

import numpy as np

from deeplearning4j_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_torch.nlp.vocab import VocabConstructor


class BagOfWordsVectorizer:
    """Document -> word-count vector (reference:
    bagofwords/vectorizer/BagOfWordsVectorizer.java)."""

    def __init__(self, min_word_frequency: int = 1, tokenizer_factory=None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or \
            DefaultTokenizerFactory()
        self.vocab = None

    def fit(self, documents) -> "BagOfWordsVectorizer":
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            tokenizer_factory=self.tokenizer_factory,
            build_huffman=False).build_vocab(documents)
        return self

    def transform(self, document: str) -> np.ndarray:
        v = np.zeros(self.vocab.num_words(), np.float32)
        for t in self.tokenizer_factory.create(document).tokens():
            i = self.vocab.index_of(t)
            if i >= 0:
                v[i] += 1.0
        return v

    def fit_transform(self, documents) -> np.ndarray:
        documents = list(documents)
        self.fit(documents)
        return np.stack([self.transform(d) for d in documents])


class TfidfVectorizer(BagOfWordsVectorizer):
    """TF-IDF weighting (reference: bagofwords/vectorizer/TfidfVectorizer.java
    — idf = log(N / df), tf raw count)."""

    def fit(self, documents) -> "TfidfVectorizer":
        documents = list(documents)
        super().fit(documents)
        V = self.vocab.num_words()
        df = np.zeros(V, np.float64)
        for d in documents:
            seen = {self.vocab.index_of(t)
                    for t in self.tokenizer_factory.create(d).tokens()}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        n_docs = max(len(documents), 1)
        self.idf = np.where(df > 0, np.log(n_docs / np.maximum(df, 1.0)), 0.0)
        return self

    def transform(self, document: str) -> np.ndarray:
        tf = super().transform(document)
        return (tf * self.idf).astype(np.float32)
