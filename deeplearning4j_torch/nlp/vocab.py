"""Vocabulary: VocabWord, cache, constructor, Huffman coding (the port's
own copy of ``deeplearning4j_tpu/nlp/vocab.py``, host code: the same
index order and the same codes and points on ties).

Reference: models/word2vec/VocabWord.java, models/word2vec/wordstore/
(VocabCache SPI, inmemory/AbstractCache.java, VocabConstructor.java:32,168
buildJointVocabulary), models/word2vec/Huffman.java:34 (array-based tree
build with MAX_CODE_LENGTH=40).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class VocabWord:
    """reference: models/word2vec/VocabWord.java (word + frequency + huffman
    code/point arrays + index)."""

    word: str
    count: float = 1.0
    index: int = -1
    codes: list = field(default_factory=list)    # huffman binary code
    points: list = field(default_factory=list)   # inner-node indices

    def increment(self, by: float = 1.0) -> None:
        self.count += by


class AbstractCache:
    """In-memory vocab cache (reference: wordstore/inmemory/AbstractCache.java).
    Words are index-addressable after ``update_indices``; index order is
    descending frequency (the reference sorts the same way for Huffman)."""

    def __init__(self):
        self._words: dict[str, VocabWord] = {}
        self._by_index: list[VocabWord] = []
        self.total_word_count = 0.0

    def add_token(self, w: VocabWord) -> None:
        ex = self._words.get(w.word)
        if ex is not None:
            ex.increment(w.count)
        else:
            self._words[w.word] = w

    def increment_count(self, word: str, by: float = 1.0) -> None:
        self._words[word].increment(by)

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_frequency(self, word: str) -> float:
        w = self._words.get(word)
        return w.count if w is not None else 0.0

    def index_of(self, word: str) -> int:
        w = self._words.get(word)
        return w.index if w is not None else -1

    def word_at_index(self, idx: int) -> Optional[str]:
        if 0 <= idx < len(self._by_index):
            return self._by_index[idx].word
        return None

    def element_at_index(self, idx: int) -> VocabWord:
        return self._by_index[idx]

    def num_words(self) -> int:
        return len(self._words)

    def vocab_words(self) -> list:
        return list(self._words.values())

    def remove_below(self, min_frequency: float) -> None:
        self._words = {k: v for k, v in self._words.items()
                       if v.count >= min_frequency}

    def update_indices(self) -> None:
        """Assign indices by descending frequency (stable by word for
        determinism)."""
        self._by_index = sorted(self._words.values(),
                                key=lambda w: (-w.count, w.word))
        for i, w in enumerate(self._by_index):
            w.index = i
        self.total_word_count = float(sum(w.count for w in self._by_index))

    def counts_array(self) -> np.ndarray:
        return np.array([w.count for w in self._by_index], np.float64)


class VocabConstructor:
    """Builds a vocab from sentence iterators (reference:
    wordstore/VocabConstructor.java:32 builder, :168 buildJointVocabulary —
    tokenize + count, prune below minWordFrequency, assign indices, build
    Huffman)."""

    def __init__(self, min_word_frequency: int = 1, tokenizer_factory=None,
                 build_huffman: bool = True):
        from deeplearning4j_torch.nlp.tokenization import \
            DefaultTokenizerFactory
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or \
            DefaultTokenizerFactory()
        self.build_huffman_tree = build_huffman

    def build_vocab(self, sentences) -> AbstractCache:
        cache = AbstractCache()
        for sentence in sentences:
            toks = (list(sentence) if isinstance(sentence, (list, tuple))
                    else self.tokenizer_factory.create(sentence).tokens())
            for tok in toks:
                cache.add_token(VocabWord(tok, 1.0))
        cache.remove_below(self.min_word_frequency)
        cache.update_indices()
        if self.build_huffman_tree and cache.num_words() > 0:
            Huffman(cache).build()
        return cache


class Huffman:
    """Array-based Huffman tree (reference: models/word2vec/Huffman.java:34;
    same two-pointer merge over the frequency-sorted array, max code length
    40). Assigns ``codes``/``points`` on each VocabWord; inner-node index
    space is [0, V-1) as used by hierarchical softmax."""

    MAX_CODE_LENGTH = 40

    def __init__(self, cache: AbstractCache, max_code_length: int = 40):
        self.cache = cache
        self.MAX_CODE_LENGTH = max_code_length

    def build(self) -> None:
        words = [self.cache.element_at_index(i)
                 for i in range(self.cache.num_words())]
        V = len(words)
        if V == 0:
            return
        count = np.empty(2 * V + 1, np.float64)
        count[:V] = [w.count for w in words]
        count[V:] = 1e15
        binary = np.zeros(2 * V + 1, np.int8)
        parent = np.zeros(2 * V + 1, np.int64)

        # words are sorted descending; classic word2vec two-pointer merge
        pos1, pos2 = V - 1, V
        for a in range(V - 1):
            if pos1 >= 0 and count[pos1] < count[pos2]:
                m1, pos1 = pos1, pos1 - 1
            else:
                m1, pos2 = pos2, pos2 + 1
            if pos1 >= 0 and count[pos1] < count[pos2]:
                m2, pos1 = pos1, pos1 - 1
            else:
                m2, pos2 = pos2, pos2 + 1
            count[V + a] = count[m1] + count[m2]
            parent[m1] = V + a
            parent[m2] = V + a
            binary[m2] = 1

        for a, w in enumerate(words):
            code, point = [], []
            b = a
            while b != 2 * V - 2:
                code.append(int(binary[b]))
                point.append(b)
                b = parent[b]
                if len(code) > self.MAX_CODE_LENGTH:
                    break
            # reverse; points are inner-node ids offset to [0, V-1)
            w.codes = code[::-1]
            w.points = [V - 2] + [p - V for p in point[::-1][:-1]] \
                if len(point) > 0 else []
            # reference stores root first then the path inner nodes;
            # path length == code length
            w.points = w.points[:len(w.codes)]
