"""ModelGuesser: load a model file without knowing its format (the port
of ``deeplearning4j_tpu/utils/model_guesser.py``; a network or word
vectors load on ``device``, CUDA unless the caller passes another).

Reference: deeplearning4j-core util/ModelGuesser.java — tries
ModelSerializer restore, then Keras import, then normalizer loading, by
sniffing the file. Here detection is by magic bytes/structure, not by
trial-exception: zip (DL4J-format model archive), HDF5 (Keras), Google
word2vec binary / text word vectors.
"""

from __future__ import annotations

import zipfile


def guess_format(path: str) -> str:
    """-> 'dl4j-zip' | 'keras-h5' | 'word2vec-binary' | 'word-vectors-text'
    (raises ValueError when none match)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:4] == b"PK\x03\x04" and zipfile.is_zipfile(path):
        return "dl4j-zip"
    if head == b"\x89HDF\r\n\x1a\n":
        return "keras-h5"
    # word2vec "V D\n" header: shared by the BINARY format (rows are
    # 'word ' + raw float32 bytes) and the gensim-style TEXT format (rows
    # are 'word 0.1 0.2 ...'). Disambiguate by whether the first row
    # parses as a text vector — misreading text as binary would
    # np.frombuffer UTF-8 digits into NaN-garbage floats with no error.
    try:
        with open(path, "rb") as f:
            header = f.readline(64)
            # unbounded: a capped readline would truncate wide text rows
            # (D >= ~450 at %.6f) and misroute them into the binary reader
            row = f.readline()
        parts = header.split()
        if len(parts) == 2 and all(p.isdigit() for p in parts):
            try:
                toks = row.decode("utf-8").split()
                if len(toks) == int(parts[1]) + 1:
                    [float(t) for t in toks[1:]]
                    return "word-vectors-text"
            except (UnicodeDecodeError, ValueError):
                pass
            return "word2vec-binary"
    except OSError:
        pass
    # text vectors: first line "word f f f ..."
    try:
        with open(path, encoding="utf-8") as f:
            first = f.readline().split()
        if len(first) >= 2:
            float(first[1])
            return "word-vectors-text"
    except (OSError, UnicodeDecodeError, ValueError):
        pass
    raise ValueError(f"Unrecognized model file: {path}")


def load_model_guess(path: str, device=None):
    """Load whatever ``path`` is (reference: ModelGuesser.loadModelGuess).
    Returns the loaded object: a network on ``device``, or (words,
    vectors) host arrays for word vector formats."""
    kind = guess_format(path)
    if kind == "dl4j-zip":
        from deeplearning4j_torch.utils.model_serializer import load_model
        return load_model(path, device=device)
    if kind == "keras-h5":
        from deeplearning4j_torch.modelimport.keras import (
            import_keras_model_and_weights,
        )
        return import_keras_model_and_weights(path, device=device)
    if kind == "word2vec-binary":
        from deeplearning4j_torch.nlp.serde import read_word2vec_binary
        return read_word2vec_binary(path)
    from deeplearning4j_torch.nlp.serde import read_word_vectors_text
    return read_word_vectors_text(path)
