"""Word2Vec facade (the port of ``deeplearning4j_tpu/nlp/word2vec.py``;
reference: models/word2vec/Word2Vec.java:32 — a SequenceVectors
specialisation over sentence iterators + tokenizer)."""

from __future__ import annotations

from deeplearning4j_torch.nlp.sequence_vectors import SequenceVectors


class Word2Vec(SequenceVectors):
    """Same builder surface as the reference: layer_size, window_size,
    min_word_frequency, negative_sample, hs, subsampling, epochs/iterations;
    ``device`` as ``SequenceVectors``.

    >>> w2v = Word2Vec(layer_size=50, window=5, negative=5, device="cpu")
    >>> w2v.fit(CollectionSentenceIterator(sentences))
    >>> w2v.words_nearest("day", 5)
    """

    def __init__(self, **kw):
        kw.setdefault("elements_algorithm", "skipgram")
        super().__init__(**kw)

    # reference-name aliases
    def get_word_vector(self, word):
        return self.word_vector(word)

    def vocab_size(self) -> int:
        return self.vocab.num_words() if self.vocab is not None else 0
