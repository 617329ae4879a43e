"""The port's threefry stream (``ops/threefry.py``, numpy only) against JAX.

JAX here is this suite's CPU JAX with ``jax_threefry_partitionable`` on (its
default), as the JAX package draws its bank.  Everything is compared bit
for bit: keys, raw bits, uniforms, the normal map (exhaustively over every
float32 uniform JAX can draw), the XLA-order row sums, and the bank's
``alpha`` and unit offsets for the seeds and shapes of the port's bar."""

import fractions

import numpy as np
import pytest

import fspann_tpu  # noqa: F401  (x64 on, as the JAX package runs)
import jax
import jax.numpy as jnp
from jax import lax

from fspann_tpu.ops import coding as jcoding
from fspann_tpu_torch.ops import coding, threefry

SEEDS = [0, 7, 42, 2 ** 31 + 5]
SHAPES = [(24, 64, 128), (24, 128, 960), (3, 5, 7)]
ALPHA_TAG, R_TAG = 0x414C5048, 0x4F464653


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _jkey(seed, tag):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), tag)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_match_jax(seed):
    assert np.array_equal(threefry.prng_key(seed),
                          np.asarray(jax.random.PRNGKey(np.uint32(seed))))
    for tag in (ALPHA_TAG, R_TAG, 0, 0xFFFFFFFF):
        key = threefry.fold_in(threefry.prng_key(seed), tag)
        assert np.array_equal(key, np.asarray(_jkey(seed, tag)))
    key = threefry.fold_in(threefry.prng_key(seed), ALPHA_TAG)
    jbits = jax.random.bits(_jkey(seed, ALPHA_TAG), (5, 7, 3), jnp.uint32)
    assert np.array_equal(threefry.random_bits_32(key, (5, 7, 3)),
                          np.asarray(jbits))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bank_draws_match_jax(seed, shape):
    """The raw normal draws, ``alpha`` and ``r_unit`` of the port's bank
    equal the JAX package's bit for bit."""
    g, m, d = shape
    key = threefry.fold_in(threefry.prng_key(seed), ALPHA_TAG)
    jn = jax.random.normal(_jkey(seed, ALPHA_TAG), shape, dtype=jnp.float32)
    assert np.array_equal(_bits(threefry.normal(key, shape)), _bits(jn))
    assert np.array_equal(_bits(coding._alpha_from_seed(seed, g, m, d)),
                          _bits(jcoding._alpha_from_seed(seed, g, m, d)))
    assert np.array_equal(_bits(coding._r_unit_from_seed(seed, g, m)),
                          _bits(jcoding._r_unit_from_seed(seed, g, m)))


@pytest.mark.parametrize("shape", [(2, 3, 12), (6, 8, 16), (3, 8, 24),
                                   (2, 4, 33), (2, 8, 100), (1, 2, 2000)])
def test_alpha_matches_jax_at_test_suite_widths(shape):
    """Widths the port's tests build systems at, and widths the XLA
    summation pads (33, 100) or splits twice (2000)."""
    assert np.array_equal(_bits(coding._alpha_from_seed(13, *shape)),
                          _bits(jcoding._alpha_from_seed(13, *shape)))


def test_normal_map_matches_jax_on_every_uniform():
    """All 2^23 float32 uniforms the normal can start from (23 random
    mantissa bits), through the same ops ``jax.random.normal`` runs after
    drawing its bits."""
    bits = np.arange(1 << 23, dtype=np.uint32) << np.uint32(9)
    lo = np.nextafter(np.float32(-1), np.float32(0))

    @jax.jit
    def jax_normal(bits):
        f = lax.bitcast_convert_type(
            (bits >> np.uint32(9)) | np.uint32(0x3F800000), jnp.float32) - 1
        u = lax.max(jnp.float32(lo), f * (jnp.float32(1) - lo) + lo)
        return u, lax.mul(jnp.float32(np.sqrt(2)), lax.erf_inv(u))

    ju, jn = map(np.asarray, jax_normal(bits))
    u = np.maximum(lo, threefry.fma(threefry._floats_1_2(bits),
                                    np.float32(2), lo))
    assert np.array_equal(_bits(u), _bits(ju))
    assert np.array_equal(_bits(threefry.normal_from_uniform(u)), _bits(jn))


@pytest.mark.parametrize("d", [1, 7, 32, 33, 64, 100, 128, 960, 1024, 2000])
def test_row_sum_in_xla_order(d):
    x = np.random.default_rng(d).normal(size=(4, 5, d)).astype(np.float32)
    x = x * x
    want = jnp.sum(jnp.asarray(x), axis=-1)
    assert np.array_equal(_bits(threefry.sum_last_f32(x)), _bits(want))


def _exact_fma(a, b, c):
    """Round-to-nearest-even float32 of the exact a*b + c."""
    v = fractions.Fraction(float(a)) * fractions.Fraction(float(b)) \
        + fractions.Fraction(float(c))
    lo = np.float32(float(v))
    # float(v) rounds once to float64; step to the float32 neighbours
    cands = {lo, np.nextafter(lo, np.float32(np.inf)),
             np.nextafter(lo, np.float32(-np.inf))}
    return min(cands, key=lambda f: (abs(fractions.Fraction(float(f)) - v),
                                     int(np.float32(f).view(np.uint32)) & 1))


def test_fma_rounds_once():
    """The emulated FMA against exact rational arithmetic, on random
    operands and on sums that land on a float32 midpoint in float64 (where
    a plain float64 sum would round twice)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=400).astype(np.float32)
    b = rng.normal(size=400).astype(np.float32)
    c = rng.normal(size=400).astype(np.float32)
    # a*b = 2^-24 + t, 0 < t < 2^-53: 1 + a*b rounds to the float32
    # midpoint 1 + 2^-24 in float64 (and then down to 1), while the exact
    # value lies above it
    i = np.arange(2017, 2049, dtype=np.float64)
    tiny_a = (2.0 ** -24 * (1 + i * 2.0 ** -23)).astype(np.float32)
    tiny_b = (1 - (2 * i - 1) * 2.0 ** -24).astype(np.float32)
    a = np.concatenate([a, tiny_a, -tiny_a])
    b = np.concatenate([b, tiny_b, tiny_b])
    c = np.concatenate([c, np.ones(len(i), np.float32),
                        -np.ones(len(i), np.float32)])
    got = threefry.fma(a, b, c)
    want = np.array([_exact_fma(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    assert np.array_equal(_bits(got), _bits(want))
    # the double-rounding cases are there: a float64 sum differs on some
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (_bits(naive) != _bits(want)).any()


def test_random_bank_and_bank_from_stats_match_jax():
    for d, seed in ((16, 3), (100, 11)):
        jb = jcoding.build_random_bank(d, 8, 2, 3, 2, seed, omega=0.75)
        tb = coding.build_random_bank(d, 8, 2, 3, 2, seed, omega=0.75)
        for f in ("alpha", "r", "omega"):
            assert np.array_equal(_bits(getattr(tb, f)),
                                  _bits(getattr(jb, f))), f
        js = jcoding.bank_from_stats(np.asarray(jb.omega), np.asarray(jb.r),
                                     d, 8, 2, 3, 2, seed)
        ts = coding.bank_from_stats(np.asarray(jb.omega), np.asarray(jb.r),
                                    d, 8, 2, 3, 2, seed)
        assert np.array_equal(_bits(ts.alpha), _bits(js.alpha))
