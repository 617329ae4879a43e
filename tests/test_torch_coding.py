"""Port's LSH coding (fspann_tpu_torch/ops/coding.py) against the JAX package.

With the JAX bank carried across (``api.convert.bank_from_jax``) both
packages' host encoders give bit-identical codes and keys.  The port's own
bank comes from ``torch.Generator`` and so differs from JAX's for the same
seed; its properties (deterministic per seed, unit rows, positive widths)
are checked on their own."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.ops import coding as jcoding
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.ops import coding

torch.set_num_threads(1)


def _carry(jb):
    return bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                         np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                         jb.divisions, jb.seed)


@pytest.mark.parametrize("m,lam,tables,divisions", [(6, 2, 2, 2),
                                                    (64, 2, 2, 3),
                                                    (21, 3, 1, 2)])
def test_bank_from_jax_encodes_bit_identically(rng, m, lam, tables,
                                               divisions):
    d = 16
    sample = rng.normal(size=(1000, d)).astype(np.float32) * 3
    x = rng.normal(size=(300, d)).astype(np.float32) * 3
    jb = jcoding.build_bank_from_sample(sample, m, lam, tables, divisions, 7)
    bank = _carry(jb)
    assert (bank.code_bits, bank.code_words, bank.g, bank.d) == \
        (jb.code_bits, jb.code_words, jb.g, jb.d)
    jc, jk = jcoding.encode_numpy(x, jb)
    tc, tk = coding.encode_numpy(x, bank)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tk, jk)
    assert tc.dtype == np.uint32 and tk.dtype == np.int64
    # and the JAX device encoder agrees with both
    dc, dk = jcoding.encode(x, jb)
    np.testing.assert_array_equal(tc, np.asarray(dc))
    np.testing.assert_array_equal(tk, np.asarray(dk))


def test_encode_numpy_is_carried_verbatim():
    assert inspect.getsource(coding.encode_numpy) == \
        inspect.getsource(jcoding.encode_numpy)


def test_own_bank_deterministic_unit_rows_positive_widths(rng):
    sample = rng.normal(size=(500, 12)).astype(np.float32) * 2
    a = coding.build_bank_from_sample(sample, 8, 2, 2, 3, seed=5)
    b = coding.build_bank_from_sample(sample, 8, 2, 2, 3, seed=5)
    c = coding.build_bank_from_sample(sample, 8, 2, 2, 3, seed=6)
    for f in ("alpha", "r", "omega"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == np.float32
    assert not np.array_equal(a.alpha, c.alpha)
    assert a.alpha.shape == (6, 8, 12) and a.r.shape == (6, 8)
    np.testing.assert_allclose(np.linalg.norm(a.alpha, axis=-1), 1.0,
                               rtol=1e-5)
    assert (a.omega > 0).all()
    assert ((a.r >= 0) & (a.r < a.omega)).all()
    # omega = projected sample range / divisor
    proj = np.einsum("sd,gmd->sgm", sample.astype(np.float64),
                     a.alpha.astype(np.float64))
    np.testing.assert_allclose(a.omega, np.ptp(proj, axis=0) / 2.5,
                               rtol=1e-4)


def test_bank_from_stats_regenerates_alpha(rng):
    sample = rng.normal(size=(400, 10)).astype(np.float32)
    a = coding.build_bank_from_sample(sample, 6, 2, 2, 2, seed=9)
    b = coding.bank_from_stats(a.omega, a.r, 10, 6, 2, 2, 2, seed=9)
    for f in ("alpha", "r", "omega"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_bank_from_jax_rejects_mismatched_shapes(rng):
    jb = jcoding.build_bank_from_sample(
        rng.normal(size=(200, 8)).astype(np.float32), 4, 2, 2, 2, 1)
    with pytest.raises(ValueError):
        bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                      np.asarray(jb.omega), 5, 2, 2, 2, 1)
    with pytest.raises(ValueError):
        bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                      -np.asarray(jb.omega), 4, 2, 2, 2, 1)


def _flipped_bits(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.unpackbits((a ^ b).view(np.uint8)).sum())


@pytest.mark.parametrize("m,lam,tables,divisions", [(6, 2, 2, 2),
                                                    (64, 2, 2, 3),
                                                    (21, 3, 1, 2)])
def test_device_encode_flips_at_most_1e4_of_the_bits(rng, m, lam, tables,
                                                     divisions):
    """Device encode (``encode_backend="default"``) against the JAX device
    encoder and both host encoders: the float32 products round differently,
    so a coordinate on a bucket boundary may flip a bit; at most 1e-4 of
    all code bits may differ.  Keys and packing are exact given the codes."""
    d = 16
    sample = rng.normal(size=(1000, d)).astype(np.float32) * 3
    x = rng.normal(size=(2000, d)).astype(np.float32) * 3
    jb = jcoding.build_bank_from_sample(sample, m, lam, tables, divisions, 7)
    bank = _carry(jb)
    tc, tk = coding.encode(torch.from_numpy(x), bank, chunk=333)
    assert tc.dtype == torch.int32 and tk.dtype == torch.int64
    codes = coding.words_to_numpy(tc)
    bound = 1e-4 * x.shape[0] * bank.g * bank.code_bits
    for ref in (np.asarray(jcoding.encode(x, jb)[0]),
                jcoding.encode_numpy(x, jb)[0], coding.encode_numpy(x, bank)[0]):
        assert _flipped_bits(codes, ref) <= bound
    np.testing.assert_array_equal(tk.numpy(),
                                  coding.keys_from_codes(tc).numpy())
    # same codes from a device bank copy, and chunking changes nothing
    tc2, tk2 = coding.encode(torch.from_numpy(x), coding.bank_to(bank, "cpu"))
    assert torch.equal(tc2, tc) and torch.equal(tk2, tk)


def test_project_h_and_h1_match_jax(rng):
    d = 12
    x = rng.normal(size=(500, d)).astype(np.float32) * 2
    jb = jcoding.build_bank_from_sample(x, 16, 2, 2, 2, 3)
    bank = _carry(jb)
    h = coding.project_h(torch.from_numpy(x), bank).numpy()
    hj = np.asarray(jcoding.project_h(jnp.asarray(x), jb))
    assert h.dtype == np.int32
    assert (h != hj).mean() <= 1e-4
    assert np.abs(h.astype(np.int64) - hj).max() <= 1
    same = (h == hj).all(axis=(1, 2))
    h1 = coding.h1(torch.from_numpy(x), bank).numpy()
    np.testing.assert_array_equal(h1[same],
                                  np.asarray(jcoding.h1(jnp.asarray(x), jb))[same])
