"""JAX's threefry2x32 random stream in numpy: the same bits, uniforms and normals.

The LSH bank is a function of its seed, and a store records the seed, not
the projections (the JAX package's ``bank.npz`` and ``mesh_state.npz`` hold
no ``alpha``).  So that a store the JAX package wrote reopens here, the port
draws its bank from the very stream the JAX package draws it from:

* :func:`prng_key` is ``jax.random.PRNGKey(np.uint32(seed))``: the key
  ``[seed >> 32, seed & 0xFFFFFFFF]`` of a 32-bit seed, i.e. ``[0, seed]``;
* :func:`fold_in` is ``jax.random.fold_in``: the threefry hash of the
  counter pair ``(0, data)`` under the key;
* :func:`random_bits_32` is ``jax._src.prng._threefry_random_bits_partitionable``
  for 32-bit words (JAX's default, ``jax_threefry_partitionable=True``): the
  hash of each element's 64-bit row-major index, split in two 32-bit
  counters, and the two output words XORed;
* :func:`uniform` is ``jax._src.random._uniform`` for float32: 23 random
  mantissa bits under the exponent of 1, minus 1, scaled and shifted, and
  clamped below at ``lo``;
* :func:`normal` is ``jax._src.random._normal_real`` for float32:
  ``sqrt(2) * erf_inv(u)`` of a uniform ``u`` in ``(-1, 1)``.

``erf_inv`` and the ``log1p`` inside it are written out the way XLA's CPU
backend computes them in float32 (the fused loop of ``chlo.erf_inv``: Giles'
single-precision polynomials over ``w = -log1p(-u*u)``, ``log1p`` as the
Cephes rational form for ``|x| < sqrt(2) - 1`` and ``log(1 + x)``
otherwise, ``log`` as XLA's own range reduction and polynomial), with a
fused multiply-add wherever XLA's compiled loop has one.  Only IEEE basic
operations are used: float32 ``+ - * / sqrt`` from numpy, which round
correctly on every host, and :func:`fma`, emulated in float64 with
round-to-odd so that its one rounding to float32 is exact.  No numpy
transcendental and no numpy reduction of float32 enters, because those
differ between numpy builds (SIMD loops, pairwise sums), and the bank must
come out the same on every host that builds it.

This module imports neither jax nor torch.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_F32 = np.float32

# threefry2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block hash (20 rounds) of counter pairs
    ``(x0, x1)`` under ``key`` (two uint32 words), as JAX computes it."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(_PARITY)))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, _U32) + ks[0]
        x1 = np.asarray(x1, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(np.uint32(seed))`` as two uint32 words."""
    return np.array([0, np.uint32(seed)], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    a, b = threefry2x32(key, np.zeros(1, _U32),
                        np.array([np.uint32(data)], _U32))
    return np.array([a[0], b[0]], _U32)


def random_bits_32(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element (JAX's partitionable threefry scheme):
    each element hashes its row-major index as (high, low) 32-bit
    counters, and the two output words are XORed."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    b1, b2 = threefry2x32(key, hi, lo)
    return (b1 ^ b2).reshape(shape)


# ----------------------------------------------------------------------------
# Float32 arithmetic with one rounding per operation
# ----------------------------------------------------------------------------

def _as_f32(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, _U32).view(_F32)


def fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as the FMA instruction does.

    ``a * b`` is exact in float64 (24 + 24 bits).  The float64 sum is made
    round-to-odd from its exact error (two-sum), and a round-to-odd result
    with 53 >= 24 + 2 bits rounds to float32 as the exact value would."""
    a = np.asarray(a, _F32).astype(np.float64)
    b = np.asarray(b, _F32).astype(np.float64)
    c = np.asarray(c, _F32).astype(np.float64)
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    bits = s.view(np.int64)
    even = (bits & 1) == 0
    fix = (err != 0) & even
    away = (err > 0) == (s > 0)       # the exact value lies farther from 0
    bits = np.where(fix, bits + np.where(away, 1, -1), bits)
    return bits.view(np.float64).astype(_F32)


def _h(*bits: int) -> tuple:
    """float32 constants given as the float64 bit patterns XLA prints."""
    return tuple(_F32(np.array(b, np.uint64).view(np.float64)) for b in bits)


# XLA's float32 log: frexp-style reduction to m in [0.5, 1), a shift to
# [sqrt(.5), sqrt(2)), then a degree-9 polynomial in three interleaved
# parts, with the exponent's contribution split in a high and a low part.
(_LOG_SQRT_HALF, _LOG_EXP_LO, _LOG_EXP_HI, _MIN_NORMAL) = _h(
    0x3FE6A09E60000000, 0xBF2BD01060000000, 0x3FE6300000000000,
    0x3810000000000000)
_LOG_P = _h(                                  # three chains, three terms each
    0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
    0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
    0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000)


def log_f32(x: np.ndarray) -> np.ndarray:
    """``log`` of positive finite float32 values, as XLA's CPU backend
    computes it (its special cases for 0, inf and negatives are left out:
    the normal's arguments lie in [2^-23, 1])."""
    x = np.asarray(x, _F32)
    bits = np.maximum(x, _MIN_NORMAL).view(_U32)
    e = ((bits >> _U32(23)).astype(np.int32) - 127).astype(_F32) + _F32(1)
    m = _as_f32((bits & _U32(0x7FFFFF)) | _U32(0x3F000000))
    small = m < _LOG_SQRT_HALF
    e = e - np.where(small, _F32(1), _F32(0))
    t = (m + _F32(-1)) + np.where(small, m, _F32(0))
    t2 = t * t
    t3 = t2 * t
    c = _LOG_P
    p0 = fma(t, c[0], c[1])
    p1 = fma(t, c[3], c[4])
    p2 = fma(t, c[6], c[7])
    p0 = fma(p0, t, c[2])
    p1 = fma(p1, t, c[5])
    p2 = fma(p2, t, c[8])
    y = fma(p0, t3, p1)
    y = fma(y, t3, p2)
    y = fma(y, t3, e * _LOG_EXP_LO)
    r = fma(_F32(-0.5), t2, t) + y
    return fma(_LOG_EXP_HI, e, r)


# Cephes' log1p rational approximation for |x| < sqrt(2) - 1
_LOG1P_P = _h(
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000)
_LOG1P_Q = _h(
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)
(_LOG1P_SMALL,) = _h(0x3FDA8279A0000000)


def log1p_f32(x: np.ndarray) -> np.ndarray:
    """``log1p`` of float32 values > -1, as XLA's CPU backend computes it."""
    x = np.asarray(x, _F32)
    large = log_f32(x + _F32(1))
    x2 = x * x
    zero = x * _F32(0)
    q = zero + _F32(1)
    for c in _LOG1P_Q:
        q = fma(q, x, c)
    p = zero + _LOG1P_P[0]
    for c in _LOG1P_P[1:]:
        p = fma(p, x, c)
    small = x + fma(_F32(-0.5), x2, (x * x2) * (p / q))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, large).astype(_F32)


# Giles, "Approximating the erfinv function" (GPU Gems Pro), single
# precision: one polynomial for w < 5, one in sqrt(w) beyond.
_ERFINV_LT5 = _h(
    0x3E5E2CB100000000, 0x3E970966C0000000, 0xBECD8E6AE0000000,
    0xBED26B5820000000, 0x3F2CA65B60000000, 0xBF548A8100000000,
    0xBF711C9DE0000000, 0x3FCF91EC60000000, 0x3FF805C5E0000000)
_ERFINV_GE5 = _h(
    0xBF2A3E1360000000, 0x3F1A76AD60000000, 0x3F561B8E40000000,
    0xBF6E17BCE0000000, 0x3F77824F60000000, 0xBF7F38BAE0000000,
    0x3F8354AFC0000000, 0x3FF006DB60000000, 0x4006A9EFC0000000)


def erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """``erf_inv`` of float32 values in (-1, 1), as XLA's CPU backend
    computes ``chlo.erf_inv`` (the ``w < 5`` test runs on ``-w``; its case
    for |x| = 1 is left out: no uniform the normal draws reaches it)."""
    x = np.asarray(x, _F32)
    neg_w = log1p_f32(x * -x)
    lt = neg_w > _F32(-5)
    v = np.where(lt, _F32(-2.5) - neg_w,
                 np.sqrt(-neg_w) + _F32(-3)).astype(_F32)
    p = fma(v, np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]),
            np.where(lt, _ERFINV_LT5[1], _ERFINV_GE5[1]))
    for c_lt, c_ge in zip(_ERFINV_LT5[2:], _ERFINV_GE5[2:]):
        p = fma(v, p, np.where(lt, c_lt, c_ge))
    return x * p


def _floats_1_2(bits: np.ndarray) -> np.ndarray:
    """23 random mantissa bits under the exponent of 1, minus 1: [0, 1)."""
    return _as_f32((bits >> _U32(9)) | _U32(0x3F800000)) - _F32(1)


def uniform(key: np.ndarray, shape: tuple[int, ...], lo: float = 0.0,
            hi: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``."""
    lo32, hi32 = _F32(lo), _F32(hi)
    f = _floats_1_2(random_bits_32(key, shape))
    return np.maximum(lo32, fma(f, hi32 - lo32, lo32))


_NORMAL_LO = np.nextafter(_F32(-1), _F32(0))
(_SQRT2,) = _h(0x3FF6A09E60000000)
_BLOCK = 1 << 14


def normal_from_uniform(u: np.ndarray) -> np.ndarray:
    """``sqrt(2) * erf_inv(u)``: the standard normal of a uniform in
    ``(-1, 1)``, as ``jax.random.normal`` maps it.  Elementwise, so it
    runs in blocks that keep its float64 temporaries in cache."""
    u = np.asarray(u, _F32)
    flat = u.reshape(-1)
    out = np.empty_like(flat)
    for lo in range(0, flat.size, _BLOCK):
        blk = flat[lo:lo + _BLOCK]
        out[lo:lo + _BLOCK] = erf_inv_f32(blk) * _SQRT2
    return out.reshape(u.shape)


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    return normal_from_uniform(uniform(key, shape, _NORMAL_LO, 1.0))


def sum_last_f32(x: np.ndarray, window: int = 32) -> np.ndarray:
    """float32 sum over the last axis in the order XLA's CPU backend adds:
    an axis longer than ``window`` is zero-padded to a whole number of
    windows (half the padding in front, the odd element behind) and cut
    into windows of ``window`` elements; each window is summed from 0 left
    to right, and the window sums are summed the same way, recursively."""
    x = np.asarray(x, _F32)
    n = x.shape[-1]
    if n > window:
        nw = -(-n // window)
        pad = nw * window - n
        if pad:
            z = x.shape[:-1]
            x = np.concatenate([np.zeros(z + (pad // 2,), _F32), x,
                                np.zeros(z + (pad - pad // 2,), _F32)],
                               axis=-1)
        x = sum_last_f32(x.reshape(x.shape[:-1] + (nw, window)), window)
        return sum_last_f32(x, window)
    acc = np.zeros(x.shape[:-1], _F32)
    for j in range(n):
        acc = acc + x[..., j]
    return acc
