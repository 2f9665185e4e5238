"""Word-vector serialization (the port of ``deeplearning4j_tpu/nlp/serde.py``;
reference: models/embeddings/loader/WordVectorSerializer.java — Google
word2vec binary format read/write + plain-text format). The files are the
contract for word vectors between the two packages: for the same tables
both write the same bytes, and each reads the other's."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.nlp.sequence_vectors import host


def write_word2vec_binary(model, path: str) -> None:
    """Google word2vec .bin format: header 'V D\\n', then per word:
    'word '<D float32 little-endian>'\\n' (reference:
    WordVectorSerializer.writeWordVectors binary path)."""
    syn0 = np.asarray(host(model.syn0), np.float32)
    # vocab size, NOT syn0.shape[0]: the rows past the vocabulary are no
    # words
    V, D = model.vocab.num_words(), syn0.shape[1]
    with open(path, "wb") as f:
        f.write(f"{V} {D}\n".encode())
        for i in range(V):
            word = model.vocab.word_at_index(i)
            f.write(word.encode("utf-8") + b" ")
            f.write(syn0[i].astype("<f4").tobytes())
            f.write(b"\n")


def read_word2vec_binary(path: str):
    """-> (words list, [V, D] float32). Tolerates the optional trailing
    newline per row (both classic layouts exist in the wild)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            header += f.read(1)
        V, D = map(int, header.split())
        words, vecs = [], np.empty((V, D), np.float32)
        for i in range(V):
            w = b""
            while True:
                c = f.read(1)
                if c in (b" ", b""):
                    break
                if c != b"\n":
                    w += c
            words.append(w.decode("utf-8", errors="replace"))
            vecs[i] = np.frombuffer(f.read(4 * D), "<f4")
    return words, vecs


def write_word_vectors_text(model, path: str) -> None:
    """Plain text: 'word v1 v2 ...' per line (reference:
    WordVectorSerializer.writeWordVectors)."""
    syn0 = host(model.syn0)
    with open(path, "w", encoding="utf-8") as f:
        # vocab size, not syn0.shape[0] (see the binary path)
        for i in range(model.vocab.num_words()):
            vec = " ".join(f"{x:.6f}" for x in syn0[i])
            f.write(f"{model.vocab.word_at_index(i)} {vec}\n")


def read_word_vectors_text(path: str):
    words, rows = [], []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            parts = line.split()  # whitespace split also strips CRLF \r
            if len(parts) < 2:
                continue
            if i == 0 and len(parts) == 2 and all(p.isdigit()
                                                  for p in parts):
                continue  # optional gensim-style "V D" count header
            words.append(parts[0])
            rows.append([float(x) for x in parts[1:]])
    return words, np.asarray(rows, np.float32)


def load_word2vec(path: str, binary: bool = True, device=None):
    """-> a queryable Word2Vec with vocab + vectors on ``device`` (CUDA
    unless the caller passes another), no training state (reference:
    WordVectorSerializer.loadGoogleModel)."""
    from deeplearning4j_torch import resolve_device
    from deeplearning4j_torch.nlp.vocab import AbstractCache, VocabWord
    from deeplearning4j_torch.nlp.word2vec import Word2Vec

    dev = resolve_device(device)
    words, vecs = (read_word2vec_binary(path) if binary
                   else read_word_vectors_text(path))
    m = Word2Vec(layer_size=vecs.shape[1], device=dev)
    cache = AbstractCache()
    # preserve file order as index order: descending pseudo-frequency
    for r, w in enumerate(words):
        cache.add_token(VocabWord(w, count=float(len(words) - r)))
    cache.update_indices()
    m.vocab = cache
    order = np.asarray([cache.index_of(w) for w in words])
    syn0 = np.empty_like(vecs)
    syn0[order] = vecs
    m.syn0 = torch.from_numpy(syn0).to(dev)
    return m
