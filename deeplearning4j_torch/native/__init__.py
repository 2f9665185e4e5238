"""The framework's own native pieces (C, loaded via ctypes): the port of
``deeplearning4j_tpu/native``, with its own byte-identical copies of
``fastio.c`` (numeric CSV parsing, the data-loader hot path) and
``skipgram.c`` (the skip-gram, CBOW/DM and pair negative-sampling training
loops that ``SequenceVectors``' ``"auto"`` and ``"native"`` backends run).

Build contract: the shared object is compiled ON FIRST USE with the
host's C compiler (``cc -O2 -shared -fPIC``; the skip-gram loops with
``-O3 -ffast-math``) into the gitignored ``native/.cache/`` directory,
KEYED BY SOURCE HASH: no prebuilt binary is ever committed or loaded, so
the bytes that run come from the .c file beside this module. Every
consumer falls back to its pure-Python (or device) path when the compiler
or the build is unavailable: native is an accelerator, never a hard
dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_CACHE_DIR = os.path.join(_DIR, ".cache")
_SRC = os.path.join(_DIR, "fastio.c")

_lock = threading.Lock()
_lib = None
_tried = False


def _build(src: str, stem: str, flags, libs=()) -> "str | None":
    """Compile ``src`` into the gitignored cache dir, the artifact named
    by the source's content hash: a reviewed-source edit can never load a
    stale binary, and the cache survives across processes. Returns the
    .so path, or None when the toolchain/build is unavailable."""
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    so = os.path.join(_CACHE_DIR, f"{stem}-{digest}.so")
    if os.path.exists(so):
        return so
    cc = (os.environ.get("CC") or shutil.which("cc")
          or shutil.which("gcc"))
    if cc is None:
        return None
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        subprocess.run([cc, *flags, "-o", tmp, src, *libs], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: concurrent builders race benignly
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build(_SRC, "_fastio", ["-O2", "-shared", "-fPIC"])
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.parse_numeric_csv.restype = ctypes.c_long
        lib.parse_numeric_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------- skipgram
_SG_SRC = os.path.join(_DIR, "skipgram.c")
_sg_lib = None
_sg_tried = False


def _load_skipgram():
    global _sg_lib, _sg_tried
    with _lock:
        if _sg_tried:
            return _sg_lib
        _sg_tried = True
        # -O3 -ffast-math: the dot/axpy inner loops vectorize; the
        # reference's libnd4j kernel is likewise SIMD C++
        so = _build(_SG_SRC, "_skipgram",
                    ["-O3", "-ffast-math", "-shared", "-fPIC"],
                    libs=["-lm"])
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.skipgram_train.restype = ctypes.c_long
        lib.skipgram_train.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_ulonglong]
        _sg_lib = lib
        return _sg_lib


def skipgram_native_available() -> bool:
    return _load_skipgram() is not None


def skipgram_train(syn0, syn1neg, corpus, table, *, window: int,
                   negative: int, alpha: float, min_alpha: float,
                   epochs: int = 1, seed: int = 1):
    """In-place native skip-gram NS training (the AggregateSkipGram hot
    loop, SkipGram.java:215-272 / its libnd4j kernel). ``syn0``/``syn1neg``
    are float32 C-contiguous [vocab, layer]; ``corpus`` int32 word indices
    with -1 sentence separators; ``table`` int32 unigram^0.75 sampling
    table. Returns trained pair count, or None when native is
    unavailable (callers use the device path)."""
    lib = _load_skipgram()
    if lib is None:
        return None
    syn0 = np.ascontiguousarray(syn0, np.float32)
    syn1neg = np.ascontiguousarray(syn1neg, np.float32)
    corpus = np.ascontiguousarray(corpus, np.int32)
    table = np.ascontiguousarray(table, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    pairs = lib.skipgram_train(
        syn0.ctypes.data_as(fp), syn1neg.ctypes.data_as(fp),
        syn0.shape[0], syn0.shape[1],
        corpus.ctypes.data_as(ip), len(corpus),
        table.ctypes.data_as(ip), len(table),
        window, negative, alpha, min_alpha, epochs, seed)
    if pairs < 0:
        return None
    return pairs, syn0, syn1neg


def parse_numeric_csv(path: str, delimiter: str = ",",
                      skip_lines: int = 0):
    """Parse a purely numeric CSV file natively -> float64 [rows, cols],
    or None when the fast path does not apply (no native lib, non-numeric
    fields, ragged rows) — callers then use the Python reader."""
    lib = _load()
    if lib is None or len(delimiter) != 1:
        return None
    try:
        with open(path, "rb") as f:
            buf = f.read() + b"\0"  # strtod needs NUL-terminated memory
    except OSError:
        return None
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    n = len(buf) - 1
    # pass 1: validate + count
    rc = lib.parse_numeric_csv(buf, n, delimiter.encode()[0], skip_lines,
                               None, ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    out = np.empty(rows.value * cols.value, np.float64)
    rc = lib.parse_numeric_csv(
        buf, n, delimiter.encode()[0], skip_lines,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    return out.reshape(rows.value, cols.value)


NATIVE_MAX_LAYER = 4096  # fixed accumulator size in skipgram.c


def _bind_pairs(lib):
    """Bind pairs_train, or None when the loaded .so predates it (stale
    artifact with equal mtime): native stays a soft dependency."""
    if not hasattr(lib, "pairs_train"):
        return None
    if not hasattr(lib, "_pairs_bound"):
        lib.pairs_train.restype = ctypes.c_long
        lib.pairs_train.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_ulonglong]
        lib._pairs_bound = True
    return lib


def ns_pairs_train(syn0, syn1neg, rows, targets, table, *, negative: int,
                   alpha: float, min_alpha: float, epochs: int = 1,
                   seed: int = 1):
    """In-place native negative-sampling pair training: rows[i] (syn0
    input row) predicts targets[i] (syn1neg output row) — the DBOW hot
    loop (sequence/DBOW.java) and any other pre-generated pair stream.
    Returns trained pair count + updated arrays, or None when the native
    library is unavailable."""
    lib = _load_skipgram()
    if lib is None or _bind_pairs(lib) is None:
        return None
    syn0 = np.ascontiguousarray(syn0, np.float32)
    syn1neg = np.ascontiguousarray(syn1neg, np.float32)
    rows = np.ascontiguousarray(rows, np.int32)
    targets = np.ascontiguousarray(targets, np.int32)
    table = np.ascontiguousarray(table, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = lib.pairs_train(
        syn0.ctypes.data_as(fp), syn1neg.ctypes.data_as(fp),
        syn0.shape[1],
        rows.ctypes.data_as(ip), targets.ctypes.data_as(ip), len(rows),
        table.ctypes.data_as(ip), len(table),
        negative, alpha, min_alpha, epochs, seed)
    if n < 0:
        return None
    return n, syn0, syn1neg


def _bind_cbow(lib):
    """Bind cbow_train, or None when the loaded .so predates it."""
    if not hasattr(lib, "cbow_train"):
        return None
    if not hasattr(lib, "_cbow_bound"):
        lib.cbow_train.restype = ctypes.c_long
        lib.cbow_train.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_ulonglong]
        lib._cbow_bound = True
    return lib


NATIVE_MAX_WINDOW = 64  # fixed context buffer in cbow_train


def cbow_native_available() -> bool:
    """The loaded .so exports cbow_train (a stale artifact may not)."""
    lib = _load_skipgram()
    return lib is not None and _bind_cbow(lib) is not None


def pairs_native_available() -> bool:
    """The loaded .so exports pairs_train (a stale artifact may not)."""
    lib = _load_skipgram()
    return lib is not None and _bind_pairs(lib) is not None


def cbow_train(syn0, syn1neg, corpus, table, *, window: int, negative: int,
               alpha: float, min_alpha: float, epochs: int = 1,
               seed: int = 1, labels=None):
    """In-place native CBOW/DM training (CBOW.java / DM.java hot loop):
    the averaged context window — plus the per-position ``labels`` row
    for DM — predicts the center word via negative sampling. Returns
    trained position count + updated arrays, or None when native is
    unavailable."""
    lib = _load_skipgram()
    if lib is None or _bind_cbow(lib) is None:
        return None
    syn0 = np.ascontiguousarray(syn0, np.float32)
    syn1neg = np.ascontiguousarray(syn1neg, np.float32)
    corpus = np.ascontiguousarray(corpus, np.int32)
    table = np.ascontiguousarray(table, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.int32)
        lab_ptr = labels.ctypes.data_as(ip)
    else:
        lab_ptr = None
    n = lib.cbow_train(
        syn0.ctypes.data_as(fp), syn1neg.ctypes.data_as(fp),
        syn0.shape[1],
        corpus.ctypes.data_as(ip), len(corpus), lab_ptr,
        table.ctypes.data_as(ip), len(table),
        window, negative, alpha, min_alpha, epochs, seed)
    if n < 0:
        return None
    return n, syn0, syn1neg
