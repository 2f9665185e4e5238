"""NLP embedding stack (the port of ``deeplearning4j_tpu/nlp``; reference:
deeplearning4j-nlp-parent). ``distributed.py`` shards the embedding
tables by vocabulary row over a mesh's ``model`` axis.

- ``tokenization`` — tokenizer factories, sentence iterators, preprocessors
  (reference: text/tokenization/, text/sentenceiterator/)
- ``vocab`` — VocabWord, VocabCache, VocabConstructor, Huffman tree
  (reference: models/word2vec/wordstore/, models/word2vec/Huffman.java)
- ``learning`` — SkipGram/CBOW/DBOW updates on torch tensors
  (reference: models/embeddings/learning/impl/elements/)
- ``sequence_vectors`` — the generic embedding trainer engine
  (reference: models/sequencevectors/SequenceVectors.java)
- ``word2vec`` / ``paragraph_vectors`` / ``glove`` — model facades
  (reference: models/word2vec/, models/paragraphvectors/, models/glove/)
- ``serde`` — word-vector serialization incl. Google word2vec binary format
  (reference: models/embeddings/loader/WordVectorSerializer.java)
- ``bagofwords`` — BoW / TF-IDF vectorizers (reference: bagofwords/)
"""

from deeplearning4j_torch.nlp.vocab import (
    AbstractCache,
    Huffman,
    VocabConstructor,
    VocabWord,
)
from deeplearning4j_torch.nlp.tokenization import (
    CollectionSentenceIterator,
    CommonPreprocessor,
    CjkTokenizerFactory,
    DefaultTokenizerFactory,
    FileSentenceIterator,
    LineSentenceIterator,
)
from deeplearning4j_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_torch.nlp.word2vec import Word2Vec
from deeplearning4j_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_torch.nlp.glove import Glove

__all__ = [
    "AbstractCache", "Huffman", "VocabConstructor", "VocabWord",
    "CollectionSentenceIterator", "CommonPreprocessor",
    "CjkTokenizerFactory", "DefaultTokenizerFactory", "FileSentenceIterator", "LineSentenceIterator",
    "SequenceVectors", "Word2Vec", "ParagraphVectors", "Glove",
]
