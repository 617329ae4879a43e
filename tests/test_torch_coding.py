"""Port's LSH coding (fspann_tpu_torch/ops/coding.py) against the JAX package.

A bank built from a sample equals the JAX package's bit for bit (``alpha``,
``r`` and ``omega``): the sample's projection extremes are taken in the
order XLA:CPU's dot sums (``coding._xla_cpu_dot_f32``, held to XLA's float32
product over a grid of shapes here), and the division by the divisor is the
product with its float32 reciprocal that XLA compiles.  With the JAX bank
carried across (``api.convert.bank_from_jax``) both packages' host encoders
give bit-identical codes and keys."""

import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.io import synthetic
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


def _encode_parts(fn):
    """``fn``'s statements before its chunks, and the work of one chunk:
    the body of the JAX package's ``for lo in range(0, n, chunk)`` loop,
    or of the port's ``encode_chunk``, less the line that notes the thread
    that took the chunk.  Docstrings left out."""
    body = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0].body[1:]
    loop = next(i for i, st in enumerate(body)
                if isinstance(st, (ast.For, ast.FunctionDef)))
    work = body[loop].body
    if isinstance(body[loop], ast.FunctionDef):
        assert "took.add" in ast.unparse(work[0])
        work = work[1:]
    return ([ast.dump(st) for st in body[:loop]],
            [ast.dump(st) for st in work])


def test_encode_numpy_is_carried_verbatim():
    """The port's host encode is the JAX package's: the same set-up and,
    chunk by chunk, the same arithmetic; only the chunks' scheduling (a
    pool of host threads) is the port's own."""
    port_setup, port_chunk = _encode_parts(coding.encode_numpy)
    jax_setup, jax_chunk = _encode_parts(jcoding.encode_numpy)
    assert port_chunk == jax_chunk and len(jax_chunk) > 10
    assert port_setup[:len(jax_setup)] == jax_setup
    assert port_setup[len(jax_setup):] == [ast.dump(ast.parse(
        "took = set()").body[0])]


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


def _sample(kind, n, d, seed):
    if kind == "normal":
        return np.random.default_rng(seed).normal(size=(n, d)) \
            .astype(np.float32)
    return synthetic.lsh_hard_corpus(n, d, 1, seed=seed)[0]


@pytest.mark.parametrize("kind", ["normal", "hard"])
@pytest.mark.parametrize("n", [257, 1_000, 4_096])
@pytest.mark.parametrize("seed", [7, 13, 42])
@pytest.mark.parametrize("d", [16, 128, 256, 512, 960])
def test_bank_from_sample_equals_jax(d, seed, n, kind):
    """The package's default bank shape (m 24, 6 tables x 3 divisions: a
    432-column projection, which XLA sums in 4 chains) built from the same
    sample by both packages: equal bit for bit."""
    sample = _sample(kind, n, d, seed)
    jb = jcoding.build_bank_from_sample(sample, 24, 2, 6, 3, seed)
    tb = coding.build_bank_from_sample(sample, 24, 2, 6, 3, seed)
    for f in ("alpha", "r", "omega"):
        got, want = getattr(tb, f), np.asarray(getattr(jb, f))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("d", [1, 4, 7, 16, 33, 128, 960, 1_030])
def test_projection_order_matches_xla_dot(d):
    """``_xla_cpu_dot_f32`` with the chains ``_ynn_lanes`` picks equals
    XLA:CPU's float32 product at every column count from 2 to 140 and at
    the shipped configurations' 432, 1,152 and 1,536: all three kernels
    (1, 2 and 4 chains), their blocks past 512 chains deep and their
    tails.  (XLA's order is another at d = 2 and 3, and for samples of at
    most 4 rows times fewer than 8 columns: README "The bank".)"""
    import jax

    dot = jax.jit(lambda s, a: jnp.einsum(
        "sd,nd->sn", s, a, precision=jax.lax.Precision.HIGHEST))
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(8, d)) * 3).astype(np.float32)
    seen = set()
    for n in list(range(2, 141)) + [432, 1_152, 1_536]:
        a = rng.normal(size=(n, d)).astype(np.float32)
        want = np.asarray(dot(x, a)).reshape(-1)
        lanes = coding._ynn_lanes(n, d)
        seen.add(lanes)
        got = coding._xla_cpu_dot_f32(np.repeat(x, n, 0), np.tile(a, (8, 1)),
                                      lanes)
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")
    assert seen == ({1, 4} if d == 1 else {1, 2, 4})


def test_projection_extremes_keep_every_candidate():
    """Rows tied in float64 (duplicates, and a sample on a coarse grid):
    the screen keeps all of them and the extremes are XLA's."""
    rng = np.random.default_rng(5)
    base = np.round(rng.normal(size=(300, 24)) * 4) / 4
    sample = np.concatenate([base, base[:50]]).astype(np.float32)
    jb = jcoding.build_bank_from_sample(sample, 10, 2, 2, 2, 3)
    tb = coding.build_bank_from_sample(sample, 10, 2, 2, 2, 3)
    np.testing.assert_array_equal(tb.omega, np.asarray(jb.omega))
    np.testing.assert_array_equal(tb.r, np.asarray(jb.r))


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
