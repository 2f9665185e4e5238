"""Port parity: the port's threefry PRNG (``deeplearning4j_torch/ops/random.py``)
against ``jax.random`` (threefry2x32, partitionable, 64-bit integers on as
``tests/conftest.py`` sets them): keys, ``fold_in``, ``split``, raw bits,
``uniform``, ``gumbel`` and ``categorical`` must be bitwise equal, in f32,
bf16 and f16 (``categorical`` in f32 and bf16), for odd sizes and for the
``[B, V]`` shape the sampler draws. The Gumbel noise rests on XLA's CPU
logarithm, which the port reproduces (``_xla_log``); it is held against
``jnp.log`` bit for bit too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_torch.ops import random as R  # noqa: E402

pytestmark = pytest.mark.torch_port

SEEDS = [0, 1, 42, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 40 + 7,
         -1, -5, 2 ** 63 - 1, -2 ** 63]
SHAPES = [(), (1,), (7,), (3, 5), (8, 256), (4, 3, 2)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}


def _np(a):
    return np.asarray(a).astype(np.int64)


def _key(seed):
    """The port's ``PRNGKey(seed)`` on the host, as the JAX side runs."""
    return R.PRNGKey(seed, device="cpu")


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(R.PRNGKey(seed, device="cpu").numpy(),
                                  _np(jax.random.PRNGKey(seed)))


def test_prng_key_outside_int64_raises():
    with pytest.raises(OverflowError):
        R.PRNGKey(2 ** 63, device="cpu")


@pytest.mark.parametrize("data", [0, 1, 5, 2 ** 31 + 3, 2 ** 32 - 1])
def test_fold_in_matches_jax(data):
    k = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(R.fold_in(_key(7), data).numpy(),
                                  _np(jax.random.fold_in(k, data)))


def test_fold_in_per_row_matches_vmapped_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    counts = np.array([0, 1, 7, 300, 2 ** 20])
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(counts))
    got = R.fold_in(torch.from_numpy(_np(keys)), torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches_jax(num):
    np.testing.assert_array_equal(
        R.split(_key(11), num).numpy(),
        _np(jax.random.split(jax.random.PRNGKey(11), num)))


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_match_jax(shape, width):
    dt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[width]
    want = jax.random.bits(jax.random.PRNGKey(9), shape, dt)
    np.testing.assert_array_equal(R.random_bits(_key(9), width, shape).numpy(),
                                  _np(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_matches_jax(shape, dtype):
    jd, td = DTYPES[dtype]
    want = jax.random.uniform(jax.random.PRNGKey(5), shape, jd)
    got = R.uniform(_key(5), shape, td)
    assert got.dtype == td and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(7,), (8, 256), (200_000,)], ids=str)
def test_gumbel_matches_jax(shape, dtype):
    jd, td = DTYPES[dtype]
    for seed in (0, 2):
        want = jax.random.gumbel(jax.random.PRNGKey(seed), shape, jd)
        got = R.gumbel(_key(seed), shape, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_categorical_matches_jax(dtype):
    """One key over a ``[B, V]`` batch (the generate loop's draw) and one
    key per row (the server's, ``vmap``), V = 256."""
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(0)
    for trial in range(4):
        logits = (rs.randn(8, 256) * 3).astype(np.float32)
        k = jax.random.PRNGKey(trial)
        jl, tl = jnp.asarray(logits).astype(jd), torch.from_numpy(logits).to(td)
        np.testing.assert_array_equal(
            R.categorical(_key(trial), tl).numpy(),
            _np(jax.random.categorical(k, jl)))
        keys = jax.random.split(k, 8)
        np.testing.assert_array_equal(
            R.categorical_rows(torch.from_numpy(_np(keys)), tl).numpy(),
            _np(jax.vmap(jax.random.categorical)(keys, jl)))


def test_xla_log_matches_jnp_log():
    """f32: a million uniform values, wide magnitudes, subnormals (read as
    zero), zero, one, inf and negatives; bf16 and f16: every finite
    non-negative value."""
    rs = np.random.RandomState(0)
    x = np.concatenate([
        rs.rand(1_000_000).astype(np.float32),
        (rs.rand(10_000) * 1e30).astype(np.float32),
        np.float32(2.0 ** -126) * rs.rand(100).astype(np.float32),
        np.array([0, 1, np.inf, -1, 2.0 ** -149, 3e38], np.float32)])
    with np.errstate(all="ignore"):
        want = np.asarray(jnp.log(x))
    got = R._xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    for bits, jd, td in ((np.arange(0, 0x7F81, dtype=np.uint32) << 16,
                          jnp.bfloat16, torch.bfloat16),
                         (None, jnp.float16, torch.float16)):
        if bits is None:
            v = np.arange(0, 0x7C01, dtype=np.uint16).view(np.float16)
            xs = v.astype(np.float32)
        else:
            xs = bits.view(np.float32)
        want = _f32(jnp.log(jnp.asarray(xs).astype(jd)))
        got = R._xla_log(torch.from_numpy(xs)).to(td).float().numpy()
        np.testing.assert_array_equal(got, want)
