"""Port parity: the port's native loader (``deeplearning4j_torch/native``)
against the JAX package's (``deeplearning4j_tpu/native``) on the CPU: the C
sources are byte-identical copies, the loader builds them into the port's
own cache (keyed by the source hash), and the parser cases of
``tests/test_native_io.py`` give the same arrays, or the same refusal
(None), from both loaders. The training loops' tables are held bitwise to
the JAX package's in ``tests/test_torch_nlp.py``.
"""

import os
import pathlib

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_torch import native as tnative

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["fastio.c", "skipgram.c"])
def test_c_sources_are_byte_identical_copies(name):
    port = (ROOT / "deeplearning4j_torch" / "native" / name).read_bytes()
    ref = (ROOT / "deeplearning4j_tpu" / "native" / name).read_bytes()
    assert port == ref


def test_loader_builds_into_the_ports_own_cache():
    """Every probe answers, the constants are the JAX package's, and the
    shared objects come from the port's ``native/.cache`` named by the
    sources' hash."""
    assert tnative.native_available() and tnative.skipgram_native_available()
    assert tnative.cbow_native_available() and \
        tnative.pairs_native_available()
    assert tnative.NATIVE_MAX_LAYER == jnative.NATIVE_MAX_LAYER
    assert tnative.NATIVE_MAX_WINDOW == jnative.NATIVE_MAX_WINDOW
    cache = ROOT / "deeplearning4j_torch" / "native" / ".cache"
    for lib in (tnative._load(), tnative._load_skipgram()):
        assert os.path.dirname(lib._name) == str(cache)


def _write(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)


CASES = {
    "numeric": ("\n".join(",".join(f"{v:.6f}" for v in row) for row in
                          np.random.RandomState(0).randn(500, 12)) + "\n",
                {}),
    "skip_semicolon": ("a;b\n1;2\n3;4\n", dict(delimiter=";",
                                               skip_lines=1)),
    "crlf_blank": ("1,2\r\n\r\n3,4\r\n", {}),
    "non_numeric": ("1,x\n2,3\n", {}),
    "ragged": ("1,2\n3,4,5\n", {}),
    "empty_field": ("1,,3\n", {}),
    "empty_trailing_field": ("1, \n2,3\n", {}),
    "whitespace_line": ("1,2\n   \n3,4\n", {}),
    "hex_float": ("0x10,2\n3,4\n", {}),
    "tab": ("1.5\t2.5\n3.5\t4.5\n", dict(delimiter="\t")),
    "space_empty_field": ("1  2\n3 4\n", dict(delimiter=" ")),
    "space": ("1 2\n3 4\n", dict(delimiter=" ")),
    "two_char_delimiter": ("1,2\n", dict(delimiter=",,")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parser_equals_jax_loader(case, tmp_path):
    text, kw = CASES[case]
    p = str(tmp_path / "d.csv")
    _write(p, text)
    got = tnative.parse_numeric_csv(p, **kw)
    want = jnative.parse_numeric_csv(p, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_parser_values():
    """Spot values of the accepted cases (``test_native_io.py``'s)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "d.csv")
        _write(p, "a;b\n1;2\n3;4\n")
        np.testing.assert_array_equal(
            tnative.parse_numeric_csv(p, delimiter=";", skip_lines=1),
            [[1.0, 2.0], [3.0, 4.0]])
        _write(p, "1,2\r\n\r\n3,4\r\n")
        np.testing.assert_array_equal(tnative.parse_numeric_csv(p),
                                      [[1.0, 2.0], [3.0, 4.0]])
        assert tnative.parse_numeric_csv(os.path.join(d, "missing")) is None
