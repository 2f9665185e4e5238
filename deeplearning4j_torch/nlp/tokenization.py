"""Text pipeline: tokenizers, preprocessors, sentence iterators (the port's
own copy of ``deeplearning4j_tpu/nlp/tokenization.py``, host code).

Reference: deeplearning4j-nlp text/tokenization/tokenizerfactory/
(DefaultTokenizerFactory, TokenizerFactory SPI), tokenizer/preprocessor/
(CommonPreprocessor, EndingPreProcessor), text/sentenceiterator/
(CollectionSentenceIterator, FileSentenceIterator, LineSentenceIterator,
LabelAwareSentenceIterator). The reference's vendored dictionary analyzers
(ansj/kuromoji, ~19.7k LoC of third-party Java) stay out of scope, but a
first-party ``CjkTokenizerFactory`` (script-aware character-bigram
segmentation) covers the basic CJK capability behind the same
TokenizerFactory SPI; a dictionary segmenter plugs in the same way.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Optional


class TokenPreProcess:
    """reference: tokenization/tokenizer/TokenPreProcess.java"""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits-adjacent junk (reference:
    tokenization/tokenizer/preprocessor/CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer (reference: preprocessor/EndingPreProcessor.java)."""

    def pre_process(self, token: str) -> str:
        for end in ("s", "ly", "ed", "ing", "ness"):
            if token.endswith(end) and len(token) > len(end) + 2:
                return token[:-len(end)]
        return token


class Tokenizer:
    """reference: tokenization/tokenizer/Tokenizer.java (iterator API
    collapsed to a list-returning ``tokens()``)"""

    def __init__(self, text: str, preprocessor: Optional[TokenPreProcess]):
        self._tokens = [t for t in text.split() if t]
        self._pre = preprocessor

    def tokens(self) -> list:
        if self._pre is None:
            return list(self._tokens)
        out = []
        for t in self._tokens:
            p = self._pre.pre_process(t)
            if p:
                out.append(p)
        return out

    def count_tokens(self) -> int:
        return len(self._tokens)


class TokenizerFactory:
    """reference: tokenizerfactory/TokenizerFactory.java SPI"""

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference:
    tokenizerfactory/DefaultTokenizerFactory.java)."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None):
        self._pre = preprocessor

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text, self._pre)

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre


class _CjkSegmentingTokenizer(Tokenizer):
    """Script-aware tokenizer: CJK spans (which carry no whitespace word
    boundaries) are segmented into overlapping character bigrams — the
    standard statistical fallback the reference's vendored analyzers
    (kuromoji for Japanese, smartcn-style segmenters for Chinese) improve
    on with dictionaries; non-CJK spans keep whitespace tokenization and
    CJK punctuation acts as a token boundary (CommonPreprocessor's ASCII
    regex cannot strip it downstream). First-party and dependency-free;
    plug a dictionary segmenter through the same TokenizerFactory SPI
    when higher quality is needed."""

    _CJK_RANGES = (
        (0x3005, 0x3007),    # 々 iteration mark, 〆, 〇
        (0x3040, 0x30FF),    # hiragana + katakana
        (0x31F0, 0x31FF),    # katakana phonetic extensions
        (0x3400, 0x4DBF),    # CJK ext A
        (0x4E00, 0x9FFF),    # CJK unified
        (0xAC00, 0xD7AF),    # hangul syllables
        (0xF900, 0xFAFF),    # CJK compat ideographs
        (0xFF66, 0xFF9F),    # halfwidth katakana
        (0x20000, 0x2FA1F),  # CJK ext B..F + compat supplement
    )
    # ideographic punctuation / fullwidth sentence marks: boundaries,
    # never tokens (they would otherwise flood the vocab — ASCII-focused
    # preprocessors cannot strip them)
    _CJK_PUNCT = set("\u3001\u3002\u30fb\u30fc\uff01\uff08\uff09"
                     "\uff0c\uff0e\uff1a\uff1b\uff1f\u300c\u300d"
                     "\u300e\u300f\u3008\u3009\u2026\u301c\uff5e")

    @classmethod
    def _char_class(cls, ch: str) -> str:
        if ch in cls._CJK_PUNCT:
            return "punct"
        o = ord(ch)
        if any(lo <= o <= hi for lo, hi in cls._CJK_RANGES):
            return "cjk"
        return "other"

    def __init__(self, text: str, preprocessor: Optional[TokenPreProcess]):
        import itertools

        tokens = []
        for chunk in text.split():
            for cls_, grp in itertools.groupby(chunk, key=self._char_class):
                run = "".join(grp)
                if cls_ == "punct":
                    continue  # boundary, not a token
                if cls_ == "other" or len(run) == 1:
                    tokens.append(run)
                else:  # overlapping character bigrams
                    tokens.extend(run[i:i + 2]
                                  for i in range(len(run) - 1))
        self._tokens = [t for t in tokens if t]
        self._pre = preprocessor


class CjkTokenizerFactory(TokenizerFactory):
    """Character-bigram CJK tokenizer factory (the first-party analog of
    the reference's vendored tokenizers.cjk / kuromoji analyzers, behind
    the same TokenizerFactory SPI)."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None):
        self._pre = preprocessor

    def create(self, text: str) -> Tokenizer:
        return _CjkSegmentingTokenizer(text, self._pre)

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre


class NGramTokenizerFactory(TokenizerFactory):
    """n-gram over a base tokenizer (reference:
    tokenizerfactory/NGramTokenizerFactory.java)."""

    def __init__(self, base: TokenizerFactory, min_n: int, max_n: int):
        self.base = base
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        toks = self.base.create(text).tokens()
        grams = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(toks) - n + 1):
                grams.append(" ".join(toks[i:i + n]))
        t = Tokenizer("", None)
        t._tokens = grams
        return t

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self.base.set_token_pre_processor(pre)


# ------------------------------------------------------------------ iterators
class SentenceIterator:
    """reference: text/sentenceiterator/SentenceIterator.java"""

    def __iter__(self):
        self.reset()
        return self._gen()

    def _gen(self):
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        self.sentences = list(sentences)

    def _gen(self):
        yield from self.sentences


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file (reference:
    sentenceiterator/LineSentenceIterator.java)."""

    def __init__(self, path: str):
        self.path = path

    def _gen(self):
        with open(self.path, encoding="utf-8", errors="ignore") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, line per sentence (reference:
    sentenceiterator/FileSentenceIterator.java)."""

    def __init__(self, directory: str):
        self.directory = directory

    def _gen(self):
        for root, _, files in os.walk(self.directory):
            for fn in sorted(files):
                with open(os.path.join(root, fn), encoding="utf-8",
                          errors="ignore") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yield line


class LabelledDocument:
    """reference: text/documentiterator/LabelledDocument.java"""

    def __init__(self, content: str, labels):
        self.content = content
        self.labels = labels if isinstance(labels, (list, tuple)) \
            else [labels]


class LabelAwareIterator:
    """Documents with labels, for ParagraphVectors (reference:
    text/documentiterator/LabelAwareIterator.java)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self.documents = list(documents)

    def __iter__(self):
        return iter(self.documents)

    def reset(self):
        pass
