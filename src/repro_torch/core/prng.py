"""Counter-based threefry2x32 random numbers, as ``jax.random`` draws them.

The port of the parts of ``jax.random`` that the reference uses: keys,
``split``, ``fold_in``, raw bits, ``uniform``, ``bernoulli``, ``randint``,
``normal``, ``gumbel`` and ``categorical``.  Every function takes explicit keys, keeps
no global state and runs on the device of its key, so the card and the
CPU draw the same numbers from the same key.

**Keys** are ``[..., 2]`` ``int64`` tensors holding the two 32-bit words
of a threefry key (values in ``[0, 2**32)``; ``int64`` because torch has
no shifts on ``uint32``).  A key array converted from JAX
(``np.asarray(key).astype(np.int64)``) is a key here.  Every function
that takes one key also takes a batch ``[B, 2]`` of them and returns the
batch's results stacked on a leading axis — what the reference computes
with ``jax.vmap`` over its keys.

**The scheme.**  This module implements jax's *partitionable* threefry
(``jax_threefry_partitionable=True``: ``split`` and the raw bits hash the
high and low words of each element's flat index), the default of jax
0.9.0, on which the parity tests run.  The pinned jax 0.4.37 defaults to
the other scheme (``split`` hashes ``iota(2n)``, the bits come from a
flat counter split in halves), and draws different numbers from the same
key; a reference run on 0.4.37 matches this module only with
``jax.config.update("jax_threefry_partitionable", True)``.

**Exactness.**  Keys, bits, ``uniform`` and ``bernoulli`` are integer
arithmetic and one exact float conversion, and ``randint`` integer
arithmetic alone: bit for bit equal to ``jax.random``.  ``normal`` (``sqrt(2) * erfinv(u)``) and ``gumbel``
(``-log(-log(u))``) evaluate the float32 approximations XLA's CPU backend
evaluates — Giles' ``erfinv`` polynomial, Cephes' ``logf`` and ``log1p``
(and, for the mamba init's ``log(expm1(exp(u)))``, Cephes' ``expf``,
XLA's ``expm1`` and its rational ``tanh``) — with each of XLA's fused multiply-adds rounded once and ``erfinv``'s
square root rounded correctly (:func:`_sqrt`), so they too agree with
the reference bit for bit on the CPU on jax 0.9.0.  ``categorical`` is
the argmax of logits plus that noise.  Every operation is a correctly
rounded float32 or float64 one, so the card draws the CPU's numbers bit
for bit (``chip_smoke.py`` checks it).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# -- the hash ----------------------------------------------------------------
def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor,
                 x2: Tensor) -> Tuple[Tensor, Tensor]:
    """Threefry-2x32 with 20 rounds on ``int64`` words in ``[0, 2**32)``.

    ``k1, k2`` are the key words and ``x1, x2`` the counter words; all
    four broadcast together.  Returns the two output words (on the meta
    device, which holds no values, the two words' shapes alone)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = torch.bitwise_and(x1 + ks[0], MASK)
    b = torch.bitwise_and(x2 + ks[1], MASK)
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.clone(), b.clone()
    if a.device.type == "meta":
        return a, b
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(MASK)
            hi = torch.bitwise_left_shift(b, r)
            b.bitwise_right_shift_(32 - r).bitwise_or_(hi)
            b.bitwise_and_(MASK).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        b.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return a, b


# -- keys --------------------------------------------------------------------
def PRNGKey(seed: int, device=None) -> Tensor:
    """The key of an integer seed, as ``jax.random.PRNGKey`` makes it with
    64-bit types off (the reference's setting): ``[0, seed mod 2**32]``,
    so a seed below ``2**32`` gives ``[0, seed]`` and ``-1`` gives
    ``[0, 2**32 - 1]``."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def as_key(key, device=None) -> Tensor:
    """``key`` as an ``int64`` key tensor; an int is ``PRNGKey(int)``."""
    if isinstance(key, int):
        return PRNGKey(key, device)
    key = torch.as_tensor(key, device=device)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has a last axis of 2, got {tuple(key.shape)}")
    if key.dtype != torch.int64:
        if key.dtype == torch.uint32:
            key = key.view(torch.int32).to(torch.int64) & MASK
        elif key.dtype.is_floating_point:
            raise TypeError(f"keys are integer words, got {key.dtype}")
        else:
            key = key.to(torch.int64) & MASK
    return key


def _words(key: Tensor, ndim: int) -> Tuple[Tensor, Tensor]:
    """The key's two words, shaped to broadcast over ``ndim`` trailing
    axes of a draw."""
    shape = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def _counters(shape: Sequence[int], device,
              offset: int = 0) -> Tuple[Tensor, Tensor]:
    """``iota_2x32_shape``: the high and low words of each element's flat
    index in ``shape``, counted from ``offset`` (a block of a larger
    draw whose flat indices start there)."""
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & MASK


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split``: ``num`` new keys, ``[..., num, 2]``."""
    key = as_key(key)
    k1, k2 = _words(key, 1)
    hi, lo = _counters((num,), key.device)
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def fold_in(key: Tensor, data: Union[int, Tensor]) -> Tensor:
    """``jax.random.fold_in``: the key hashed with the 32-bit ``data``.

    ``data`` is an int or an integer tensor broadcasting against the
    key's batch axes (``vmap(fold_in)(keys, data)``); it is taken modulo
    ``2**32`` as the reference's ``uint32`` conversion takes it."""
    key = as_key(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


# -- draws -------------------------------------------------------------------
def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def random_bits(key: Tensor, shape=(), *, offset: int = 0) -> Tensor:
    """32 random bits per element (``int64`` in ``[0, 2**32)``):
    ``bits1 ^ bits2`` of the element's counters.  ``[..., *shape]``.
    ``offset`` draws the elements of a larger draw whose flat indices
    start there: the partitionable scheme hashes each element's own
    index, so a block is those elements of the whole draw, bit for bit."""
    key = as_key(key)
    shape = _shape(shape)
    k1, k2 = _words(key, len(shape))
    hi, lo = _counters(shape, key.device, offset)
    a, b = threefry2x32(k1, k2, hi, lo)
    return a.bitwise_xor_(b)


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float: a scalar
    operand that torch applies to a float32 tensor exactly as that
    float32 constant."""
    return float(np.float32(v))


def uniform(key: Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, *, offset: int = 0) -> Tensor:
    """Float32 uniform on ``[minval, maxval)``: 23 mantissa bits under the
    exponent of 1.0, minus 1, scaled and shifted in one fused
    multiply-add (as XLA fuses them), then ``max(minval, ·)``."""
    bits = random_bits(key, shape, offset=offset)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp(_fma(floats, span, float(lo)), min=float(lo))


def bernoulli(key: Tensor, p: float, shape=()) -> Tensor:
    """Bool draws, true with probability ``p``: ``uniform < p`` (f32)."""
    return uniform(key, shape) < _f32(p)


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _mulmod32(a: Tensor, m: int) -> Tensor:
    """``a * m`` modulo ``2**32`` for ``a`` in ``[0, 2**32)`` and a
    constant ``m`` below ``2**32``, carried in ``int64`` without
    overflow: ``a``'s 16-bit halves times ``m`` stay below ``2**48``."""
    hi = ((a >> 16) * m) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * m) & MASK


def randint(key: Tensor, shape, minval: int, maxval: int) -> Tensor:
    """``jax.random.randint`` for ``int32``: integers in ``[minval,
    maxval)``, ``[..., *shape]``; bounds outside ``int32`` raise, as
    jax's do.

    As jax draws them: two 32-bit words per element from the halves of
    ``split(key)``, ``span = maxval - minval`` as ``uint32`` (1 when
    ``maxval <= minval``), ``multiplier = (2**16 mod span)**2 mod span``,
    and the offset ``((hi mod span) * multiplier + (lo mod span)) mod
    span``, every step in ``uint32`` wraparound; ``minval`` plus the
    offset, wrapped to ``int32``."""
    minval, maxval = int(minval), int(maxval)
    if not _I32_MIN <= min(minval, maxval) <= max(minval, maxval) <= _I32_MAX:
        raise OverflowError(f"randint bounds [{minval}, {maxval}) are not "
                            f"int32")
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (((1 << 16) % span) ** 2 & MASK) % span
    off = ((_mulmod32(hi % span, mult) + lo % span) & MASK) % span
    return (((minval + off - _I32_MIN) & MASK) + _I32_MIN).to(torch.int32)


def _fma(a: Tensor, b, c) -> Tensor:
    """Float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two floats is exact in float64, the sum rounds there and
    again to float32 (the two roundings part only where the float64 sum
    lands exactly on a float32 midpoint).  ``b`` and ``c`` are float32
    tensors or Python floats holding float32 values."""
    d = a.to(torch.float64)
    d = d * (b.to(torch.float64) if torch.is_tensor(b) else b)
    return (d + (c.to(torch.float64) if torch.is_tensor(c) else c)).to(
        torch.float32)


# Cephes' logf, which XLA's CPU backend evaluates for ``log``.
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRT_HALF = _f32(0.707106781186547524)
_TINY = float(np.finfo(np.float32).tiny)


def log(x: Tensor) -> Tensor:
    """Float32 natural log of positive ``x``, XLA's CPU evaluation of it:
    Cephes' ``logf`` (exponent split, mantissa in ``[sqrt(1/2),
    sqrt(2))``, a degree-8 polynomial) with XLA's fused multiply-adds.
    ``log(0) = -inf``; inputs below the smallest normal float count as
    it."""
    x = x.to(torch.float32)
    bits = torch.clamp(x, min=_TINY).view(torch.int32)
    e = (bits >> 23).to(torch.float32) - 126.0              # 1 + (ex - 127)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, 0.0)
    p = _LOG_P
    x2 = m * m
    x3 = x2 * m
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    r = (m - x2 * 0.5) + y
    r = r + e * _LOG_Q2
    return torch.where(x == 0.0, -math.inf, r)


# XLA's log1p below sqrt(2) - 1: a rational approximation from Cephes.
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _horner(x: Tensor, coeffs) -> Tensor:
    r = torch.zeros_like(x)
    for c in coeffs:
        r = _fma(r, x, c)
    return r


def log1p(x: Tensor) -> Tensor:
    """Float32 ``log(1 + x)`` for ``x > -1``, XLA's CPU evaluation: the
    rational approximation where ``|x| < sqrt(2) - 1``, :func:`log` of
    ``1 + x`` elsewhere."""
    x = x.to(torch.float32)
    xs = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(xs, -0.5, (x * xs) * small)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       log(x + 1.0))


# Cephes' expf, which XLA's CPU backend evaluates for ``exp``.
_EXP_P = tuple(_f32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def exp(x: Tensor) -> Tensor:
    """Float32 ``exp``, XLA's CPU evaluation: ``n = floor(x log2(e) +
    1/2)``, Cephes' two-part reduction by ``n ln 2`` and degree-5
    polynomial in fused multiply-adds, times ``2**n``.  Equal to XLA's
    where the result is a normal float (inputs in about ``[-87.3,
    88.3]``); XLA's overflow and flush-to-zero tails are not followed."""
    x = torch.clamp(x.to(torch.float32), _f32(-87.8), _f32(88.8))
    n = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5))
    x = _fma(n, -_f32(0.693359375), x)
    x = _fma(n, -_f32(-2.12194440e-4), x)
    y = _fma(x, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma(y, x, p)
    y = 1.0 + _fma(y, x * x, x)
    n = torch.clamp(n, -127.0, 127.0).to(torch.int32)
    return y * ((n + 127) << 23).view(torch.float32)


# XLA's rational tanh (Eigen's): odd numerator over even denominator.
_TANH_NUM = tuple(_f32(v) for v in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
_TANH_DEN = tuple(_f32(v) for v in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))


def tanh(x: Tensor) -> Tensor:
    """Float32 ``tanh``, XLA's CPU evaluation: ``x`` below 4e-4 in
    magnitude, else a 13/6 rational function of ``x`` clamped to
    ``±7.905``."""
    x = x.to(torch.float32)
    c = torch.clamp(x, -_f32(7.90531110763549805), _f32(7.90531110763549805))
    c2 = c * c

    def poly(coeffs):
        r = torch.full_like(c2, coeffs[0])
        for v in coeffs[1:]:
            r = _fma(r, c2, v)
        return r

    return torch.where(x.abs() < _f32(0.0004), x,
                       (c * poly(_TANH_NUM)) / poly(_TANH_DEN))


def expm1(x: Tensor) -> Tensor:
    """Float32 ``exp(x) - 1``, XLA's CPU evaluation: ``tanh(x/2) *
    (exp(x) + 1)`` below 1/2 in magnitude, ``exp(x) - 1`` above."""
    x = x.to(torch.float32)
    ex = exp(x)
    return torch.where(x.abs() < 0.5, tanh(x * 0.5) * (ex + 1.0), ex - 1.0)


def _sqrt(w: Tensor) -> Tensor:
    """Correctly rounded float32 square root of ``w``, from float64
    multiplies, adds and divides alone.  ``torch.sqrt`` on the CPU calls
    a vector-math library that rounds about 1% of float32 roots an ulp
    away, and in some worker threads of a process gave roots ~2e-4 off;
    so two Newton steps in float64 refine its float64 root, and an exact
    test against the squares of the float32 neighbours' midpoints (25
    bits, exact squared in float64) picks the nearest float32.  The same
    numbers come out on every device and thread."""
    d = w.to(torch.float64)
    r = torch.sqrt(d)
    ok = (d > 0) & torch.isfinite(d)
    safe = torch.where(ok, r, 1.0)
    for _ in range(2):
        safe = 0.5 * (safe + torch.where(ok, d, 1.0) / safe)
    f = torch.where(ok, safe, r).to(torch.float32)
    up = torch.nextafter(f, torch.full_like(f, math.inf))
    dn = torch.nextafter(f, torch.zeros_like(f))
    f64 = f.to(torch.float64)
    hi = 0.5 * (f64 + up.to(torch.float64))
    lo = 0.5 * (f64 + dn.to(torch.float64))
    fixed = torch.where(hi * hi < d, up, torch.where(lo * lo > d, dn, f))
    return torch.where(ok, fixed, f)


# Giles (2010), "Approximating the erfinv function", single precision:
# the coefficients XLA's ErfInv32 evaluates, for w < 5 and w >= 5.
_ERFINV_SMALL = tuple(_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_LARGE = tuple(_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erfinv(x: Tensor) -> Tensor:
    """Float32 inverse error function, XLA's evaluation of it:
    ``w = -log1p(-x*x)``, Giles' degree-8 polynomial in ``w - 2.5`` or
    ``sqrt(w) - 3`` in fused multiply-adds, times ``x``; ``±inf`` at
    ``x = ±1``."""
    x = x.to(torch.float32)
    w = -log1p(-(x * x))
    small = w < 5.0
    t = torch.where(small, w - 2.5, _sqrt(w) - 3.0)

    def coef(i):
        return torch.where(small, _ERFINV_SMALL[i],
                           torch.full_like(t, _ERFINV_LARGE[i]))

    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = _fma(p, t, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: Tensor, shape=(), *, offset: int = 0) -> Tensor:
    """Standard normal float32 draws: ``sqrt(2) * erfinv(u)``, ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return erfinv(uniform(key, shape, lo, 1.0, offset=offset)) * _f32(
        math.sqrt(2.0))


def normal_blocked(key: Tensor, shape, *, max_block: int = 1 << 24
                   ) -> Tensor:
    """:func:`normal` over ``shape`` (at least 1-D), drawn in blocks of
    whole rows (axis 0) of at most ``max_block`` elements into one output
    tensor: the same numbers, with the threefry temporaries (a few int64
    and float64 words per element) of one block alive at a time instead
    of the whole draw's.  A batch of keys ``[..., 2]`` draws ``[...,
    *shape]``, one key at a time; a ``meta`` key gives the empty tensor
    of that shape."""
    key = as_key(key)
    shape = _shape(shape)
    out = torch.empty(key.shape[:-1] + shape, dtype=torch.float32,
                      device=key.device)
    if key.device.type == "meta":
        return out
    row = math.prod(shape[1:])
    rows = max(1, max_block // max(row, 1))
    for idx in np.ndindex(*key.shape[:-1]):
        for r0 in range(0, shape[0], rows):
            r1 = min(r0 + rows, shape[0])
            out[idx][r0:r1] = normal(key[idx], (r1 - r0,) + shape[1:],
                                     offset=r0 * row)
    return out


def gumbel(key: Tensor, shape=()) -> Tensor:
    """Standard Gumbel float32 draws, jax's "low" mode:
    ``-log(-log(u))``, ``u`` uniform on ``[tiny, 1)``."""
    return -log(-log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: Tensor, logits: Tensor) -> Tensor:
    """One index per row of ``logits`` [..., V]: the argmax of the logits
    plus Gumbel noise drawn over their shape.  ``key`` is one key for all
    of ``logits`` or a batch ``[B, 2]`` for ``logits`` [B, V], one key a
    row (``vmap(categorical)``)."""
    key = as_key(key)
    shape = logits.shape[key.ndim - 1:]
    g = gumbel(key, shape)
    return torch.argmax(g + logits, dim=-1)
