"""The parts of ``jax.random`` that the JAX package's sampling calls, in
torch: threefry2x32 keys (``PRNGKey``, ``fold_in``, ``split``), raw bits,
``uniform``, ``bernoulli`` (dropout masks), ``gumbel`` and ``categorical``
(the Gumbel-argmax).

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of JAX's
``uint32[2]`` key; every word is kept in ``[0, 2^32)`` by masking after each
addition. ``PRNGKey`` makes its key on the card unless the caller names
another device; every other function runs on its tensors' device. The
draws are bitwise those of ``jax.random`` under JAX 0.9's defaults
(``jax_default_prng_impl="threefry2x32"``, ``jax_threefry_partitionable=True``)
with 64-bit integers enabled, as the JAX package's tests run it, so a
request served here samples the tokens the JAX package samples for the same
seed:

- ``PRNGKey(seed)`` splits the seed's 64-bit two's complement into its high
  and low words, ``[seed >> 32, seed mod 2^32]`` (without ``jax_enable_x64``
  JAX keeps only the low word, ``[0, seed mod 2^32]``: the two agree for
  seeds in ``[0, 2^32)``);
- ``random_bits`` hashes the flat index of each output element (an iota
  over the output shape, split into high and low words), as the
  partitionable threefry does, and XORs the two output words; 8- and 16-bit
  draws keep the low bits;
- ``uniform`` builds floats from the top mantissa bits as JAX's
  ``_uniform`` does (bf16, with 7 mantissa bits, draws 8-bit words);
- ``bernoulli`` is ``uniform(key, shape, dtype of p) < p``; a Python
  float ``p`` has JAX's default float dtype, f64 under 64-bit types, so
  its uniform takes 64-bit words (the two hash words, high then low); an
  array ``p`` draws in its own dtype over its own shape;
- ``normal`` is ``√2·erf_inv(u)`` with ``u`` uniform on ``[nextafter(-1,
  0), 1)``. In f32 it is bitwise XLA's CPU program: Giles' polynomial
  (``_xla_erf_inv``) over XLA's ``log1p`` (``_xla_log1p``: Cephes'
  rational function below ``√2 - 1``, ``_xla_log(1 + x)`` above) with
  fused multiply-adds, and a correctly rounded square root (XLA's is;
  torch's CPU f32 ``sqrt`` is not always). In f64 the inverse error
  function is ``torch.erfinv``, not XLA's f64 polynomial: within 2^13
  ulps of JAX's draw (about 1e-12 relative);
- ``gumbel`` is JAX's default ``mode="low"``, ``-log(-log(u))`` with ``u``
  uniform on ``[tiny, 1)``, as XLA compiles it on the CPU. Its logarithm
  is XLA's (``_xla_log``: the Cephes polynomial with fused multiply-adds,
  inputs below the smallest normal read as zero), not ``torch.log``, which
  differs from it in the last bit of about one f32 value in eight; 16-bit
  draws take each logarithm in f32 and round it to their dtype.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_torch import resolve_device

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

#: float dtype -> (bits, mantissa bits, bit pattern of 1.0, signed integer
#: dtype of the same width), as ``jnp.finfo`` gives them
_FLOAT = {torch.float32: (32, 23, 0x3F800000, torch.int32),
          torch.bfloat16: (16, 7, 0x3F80, torch.int16),
          torch.float16: (16, 10, 0x3C00, torch.int16)}


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key ``(k1, k2)``: int64 tensors of uint32 values, broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def seed_words(seed: int) -> tuple:
    """The two words of ``PRNGKey(seed)``: the high and low words of the
    seed's 64-bit two's complement. A seed outside the int64 range raises
    ``OverflowError``, as JAX's conversion does."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return (seed >> 32) & _M32, seed & _M32


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)``: an int64 ``[2]`` key (``seed_words``)
    on the card, or on ``device`` when the caller names one."""
    words = seed_words(seed)
    return torch.tensor(words, dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)`` under
    ``key``. ``key`` ``[..., 2]`` and ``data`` (an int or an integer tensor
    broadcast against the key's batch shape, taken mod 2^32) give keys of
    the broadcast batch shape."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def _counters(shape, device):
    """The partitionable threefry's counters: the flat index of each element
    of ``shape``, split into its high and low 32-bit words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one ``[2]`` key: ``[num, 2]``
    keys, key i the hash of the counter i."""
    hi, lo = _counters((num,), key.device)
    o1, o2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits`` of ``bit_width`` 8, 16 or 32 for one ``[2]`` key,
    as an int64 tensor of unsigned values."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape, key.device)
    o1, o2 = threefry2x32(key[0], key[1], hi, lo)
    return (o1 ^ o2) & ((1 << bit_width) - 1)


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` on ``[minval, maxval)`` for one ``[2]`` key in
    f32, bf16 or f16: the top mantissa bits of a random word under the
    exponent of 1.0, minus 1, then scaled and shifted in ``dtype``."""
    if dtype not in _FLOAT:
        raise TypeError(f"uniform takes {tuple(_FLOAT)}, got {dtype}")
    nbits, nmant, one, itype = _FLOAT[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, rng_bits, shape)
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(itype).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _uniform64(key: torch.Tensor, shape, minval=0.0, maxval=1.0
               ) -> torch.Tensor:
    """``jax.random.uniform`` in f64 for one ``[2]`` key: the top 52 bits
    of the 64-bit word ``(o1 << 32) | o2`` over 2^52, then scaled and
    shifted in f64."""
    hi, lo = _counters(shape, key.device)
    o1, o2 = threefry2x32(key[0], key[1], hi, lo)
    floats = ((o1 << 20) | (o2 >> 12)).to(torch.float64) * 2.0 ** -52
    return torch.clamp(floats * (maxval - minval) + minval, min=minval)


def bernoulli(key: torch.Tensor, p, shape=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (``mode="low"``) for one
    ``[2]`` key: a bool tensor, True where a uniform draw is below ``p``.

    A Python-float ``p`` takes JAX's default float dtype, f64 under 64-bit
    types (as the keys here follow): the f64 uniform is the top 52 bits of
    the 64-bit word ``(o1 << 32) | o2`` over 2^52, compared in f64 on the
    key's device. A tensor ``p`` (f32 or f64, an RBM's hidden means) draws
    a uniform of its own dtype over ``shape`` (its own shape when None)."""
    if torch.is_tensor(p):
        shape = tuple(p.shape) if shape is None else tuple(int(s)
                                                           for s in shape)
        if p.dtype == torch.float64:
            u = _uniform64(key, shape)
        elif p.dtype == torch.float32:
            u = uniform(key, shape, torch.float32)
        else:
            raise TypeError(f"bernoulli takes an f32 or f64 p, got {p.dtype}")
        return u < p
    shape = tuple(int(s) for s in shape)
    return _uniform64(key, shape) < float(p)


def _f32(x: float) -> float:
    """A Python constant rounded to f32 (exact as a Python float)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _fma32(a, b, c):
    """``a·b + c`` on f32 tensors with one rounding, as a fused multiply-add
    gives it (``b`` and ``c`` may be f32 values held as Python floats, which
    stay scalars and cost no copy to the device): the product is exact in
    f64, the sum is rounded to odd in f64 (an error-free sum, then a step to
    the odd neighbour where it was inexact), and rounding that to f32 is
    the correctly rounded result."""
    def f64(x):
        return x if isinstance(x, float) else x.double()

    p = a.double() * f64(b)
    c = f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# Cephes' log coefficients, as f32 (the polynomial of XLA's CPU log)
_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_Q1, _Q2 = _f32(-2.12194440e-4), 0.693359375
_MIN_NORMAL = 2.0 ** -126


def _xla_log(v: torch.Tensor) -> torch.Tensor:
    """The natural logarithm of f32 ``v`` bit for bit as XLA's CPU backend
    computes it: mantissa in ``[sqrt(1/2), sqrt(2))`` and exponent, the
    Cephes polynomial evaluated with fused multiply-adds in the order the
    compiled kernel runs them, the exponent added back in two parts.
    Subnormal inputs read as zero (-inf), negatives and NaN give NaN."""
    f = torch.float32
    x = torch.clamp(v, min=_MIN_NORMAL)
    b = x.view(torch.int32)
    e = ((b >> 23) - 127).to(f) + 1.0
    m = ((b & -2139095041) | 0x3F000000).view(f)      # 0x807FFFFF
    below = m < 0.70710677                            # f32 sqrt(1/2)
    x = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.to(f)
    z = x * x
    x3 = z * x
    y1 = _fma32(_fma32(x, _P[0], _P[1]), x, _P[2])
    y2 = _fma32(_fma32(x, _P[3], _P[4]), x, _P[5])
    y3 = _fma32(_fma32(x, _P[6], _P[7]), x, _P[8])
    y = _fma32(_fma32(y1, x3, y2), x3, y3)
    y = _fma32(y, x3, e * _Q1)
    x = _fma32(z, -0.5, x)
    x = _fma32(e, _Q2, x + y)
    x = torch.where(v < _MIN_NORMAL, torch.full_like(x, -math.inf), x)
    x = torch.where(v == math.inf, v, x)
    return torch.where((v < 0) | torch.isnan(v), torch.full_like(x, math.nan),
                       x)


def gumbel(key: torch.Tensor, shape=(), dtype=torch.float32,
           mode: str = "low") -> torch.Tensor:
    """``jax.random.gumbel`` (``mode="low"``, JAX's default) for one ``[2]``
    key: ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` in
    ``dtype``."""
    if mode != "low":
        raise NotImplementedError(f"gumbel mode {mode!r} is not ported "
                                  "(JAX's default is 'low')")
    if dtype not in _FLOAT:
        raise TypeError(f"gumbel takes {tuple(_FLOAT)}, got {dtype}")
    rng_bits = 8 if _FLOAT[dtype][1] < 8 else _FLOAT[dtype][0]
    return _gumbel_from_bits(random_bits(key, rng_bits, shape), dtype)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of ``logits`` plus Gumbel noise drawn in their dtype for one
    ``[2]`` key over their whole shape. Returns int64 indices."""
    g = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def categorical_rows(keys: torch.Tensor, logits: torch.Tensor
                     ) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)`` for ``[B, 2]``
    keys and ``[B, V]`` logits: row b draws its own ``[V]`` noise from
    ``keys[b]``. Returns int64 indices ``[B]``."""
    _B, V = logits.shape
    hi, lo = _counters((V,), logits.device)
    o1, o2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], hi[None], lo[None])
    g = _gumbel_from_bits(o1 ^ o2, logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def _gumbel_from_bits(bits: torch.Tensor, dtype) -> torch.Tensor:
    """Gumbel noise in ``dtype`` from hashed words (one per element; the low
    bits are used). As XLA compiles JAX's ``_gumbel`` on the CPU: the
    uniform's ``·(1 - tiny) + tiny`` folds into its ``- 1`` (so ``u`` is
    ``max(tiny, floats)``, which for f16, whose tiny is 2^-14, differs from
    ``uniform``), and each logarithm is taken in f32 and rounded to
    ``dtype``."""
    nbits, nmant, one, itype = _FLOAT[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = bits & ((1 << rng_bits) - 1)
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(itype).view(dtype) - 1.0
    u = torch.clamp(floats, min=torch.finfo(dtype).tiny)   # tiny is exact
    nl = (-_xla_log(u.float())).to(dtype)
    return (-_xla_log(nl.float())).to(dtype)


# Cephes' log1p rational function, as XLA's CPU backend emits it
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' single-precision erf_inv coefficients, w < 5 and w >= 5
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _horner32(x, coeffs):
    r = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma32(r, x, _f32(c))
    return r


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` of f32 ``x`` bit for bit as XLA's CPU backend
    computes it: below ``√2 - 1`` in magnitude, ``x - x²/2 + x³·P(x)/Q(x)``
    (Cephes' rational function, Horner with fused multiply-adds); above,
    ``_xla_log(x + 1)``."""
    x2 = x * x
    r = (x * x2) * (_horner32(x, _LOG1P_NUM) / _horner32(x, _LOG1P_DEN))
    small = x + _fma32(x2, -0.5, r)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _xla_log(x + 1.0))


def _xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function of f32 ``x`` in ``[-1, 1]`` bit for bit as
    XLA's CPU backend computes it (Giles, "Approximating the erfinv
    function"): ``w = -log1p(-x²)``, a degree-8 polynomial in ``w - 2.5``
    (``w < 5``) or ``√w - 3`` with fused multiply-adds, times ``x``;
    ``±1`` give ``±inf``."""
    w = -_xla_log1p(x * -x)
    lt = w < 5.0
    # f32 sqrt correctly rounded (through f64), as XLA's
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT[0]), _f32(_ERFINV_GE[0])).to(x)
    for a, b in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = _fma32(p, w, torch.where(lt, _f32(a), _f32(b)).to(x))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for one ``[2]`` key in f32
    (bitwise) or f64 (``torch.erfinv``: within 2^13 ulps): ``√2·erf_inv(u)``
    with ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    shape = tuple(int(s) for s in shape)
    if dtype == torch.float32:
        lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
        u = uniform(key, shape, torch.float32, lo, 1.0)
        return _f32(math.sqrt(2.0)) * _xla_erf_inv(u)
    if dtype == torch.float64:
        u = _uniform64(key, shape, math.nextafter(-1.0, 0.0), 1.0)
        return math.sqrt(2.0) * torch.erfinv(u)
    raise TypeError(f"normal takes f32 or f64, got {dtype}")
