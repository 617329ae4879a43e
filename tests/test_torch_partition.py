"""Port's partition build, packing, keys and Hamming (fspann_tpu_torch/ops/
{partition,coding,hamming}.py) against the JAX package, bit for bit.

Inputs are seeded numpy arrays handed to both packages: packed words cross
as uint32 (the port keeps int32 bit patterns on its devices).  Shapes cover
W = 1, 3 and 4 words per group (λ = 3 and the 63-bit key truncation
included), narrow and wide keys, and blocks that leave the last partition
partial."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import hamming as jhamming
from fspann_tpu.ops import partition as jpartition
from fspann_tpu_torch.api.convert import table_from_jax
from fspann_tpu_torch.ops import coding, hamming, partition

torch.set_num_threads(1)

# (m, lam): W = 1, W = 3 at λ = 3 (90 bits, keys truncate at 63), W = 4
GEOMS = [(10, 2), (30, 3), (64, 2)]


def _codes_keys(rng, n, g, m, lam, dup=False):
    """Packed codes from random H (bucket indices, negative ones too) and
    their keys, by the JAX package's packer."""
    h = rng.integers(-6, 9, size=(n, g, m)).astype(np.int32)
    if dup:   # many equal keys: ties must break by id
        h[n // 2:] = h[:n - n // 2]
    codes = np.asarray(jcoding.pack_codes(jnp.asarray(h), m, lam))
    keys = np.asarray(jcoding.keys_from_codes(jnp.asarray(codes)))
    return h, codes, keys


def _field_np(f, name):
    if f is None:
        return None
    a = f.numpy() if isinstance(f, torch.Tensor) else np.asarray(f)
    return a.view(np.uint32) if name == "rep_codes" else a


def _assert_tables_equal(port, ref):
    for name in jpartition.PartitionTable._fields:
        a, b = _field_np(getattr(port, name), name), \
            _field_np(getattr(ref, name), name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("m,lam", GEOMS)
def test_pack_codes_and_keys_match_jax(rng, m, lam):
    h, codes, keys = _codes_keys(rng, 300, 3, m, lam)
    th = torch.from_numpy(h)
    tcodes = coding.pack_codes(th, m, lam)
    assert tcodes.dtype == torch.int32
    np.testing.assert_array_equal(coding.words_to_numpy(tcodes), codes)
    np.testing.assert_array_equal(coding.keys_from_codes(tcodes).numpy(),
                                  keys)
    np.testing.assert_array_equal(
        coding.keys2_from_codes(tcodes).numpy(),
        np.asarray(jcoding.keys2_from_codes(jnp.asarray(codes))))
    np.testing.assert_array_equal(coding.keys2_from_codes_numpy(codes),
                                  jcoding.keys2_from_codes_numpy(codes))


def test_keys_at_word_boundaries():
    """All-ones and sign-bit words: keys stay 63-bit non-negative and the
    words' unsigned values are read, as JAX reads uint32."""
    words = np.array([[0xFFFFFFFF] * 4, [0x80000000, 1, 0x80000000, 3],
                      [0, 0, 0, 0], [1, 0xFFFFFFFE, 0xFFFFFFFF, 0x7FFFFFFF]],
                     np.uint32)
    t = coding.words_to_torch(words)
    for fn in ("keys_from_codes", "keys2_from_codes"):
        got = getattr(coding, fn)(t).numpy()
        want = np.asarray(getattr(jcoding, fn)(jnp.asarray(words)))
        np.testing.assert_array_equal(got, want, err_msg=fn)
        assert (got >= 0).all()
    assert coding.keys2_from_codes(t)[0] == np.iinfo(np.int64).max


@pytest.mark.parametrize("w", [1, 3, 4, 96])
def test_hamming_matches_jax(rng, w):
    a = rng.integers(0, 1 << 32, size=(5, 7, w), dtype=np.uint64) \
        .astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=(1, 7, w), dtype=np.uint64) \
        .astype(np.uint32)
    got = hamming.hamming(coding.words_to_torch(a), coding.words_to_torch(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhamming.hamming(jnp.asarray(a),
                                                 jnp.asarray(b))))
    # the popcount reads each word as 32 bits, in int32 or int64 tensors
    t = coding.words_to_torch(a)
    np.testing.assert_array_equal(hamming.popcount(t).numpy(),
                                  hamming.popcount(t.to(torch.int64) &
                                                   0xFFFFFFFF).numpy())


@pytest.mark.parametrize("m,lam", GEOMS)
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n,block", [(1000, 8), (2051, 64)])
def test_build_partitions_matches_jax(rng, m, lam, wide, n, block):
    g = 3
    _, codes, keys = _codes_keys(rng, n, g, m, lam, dup=True)
    keys_gn = np.ascontiguousarray(keys.T)
    codes_gn = np.ascontiguousarray(codes.transpose(1, 0, 2))
    ref = jpartition.build_partitions(jnp.asarray(keys_gn),
                                      jnp.asarray(codes_gn), block, wide=wide)
    dev = partition.build_partitions(torch.from_numpy(keys_gn),
                                     coding.words_to_torch(codes_gn), block,
                                     wide=wide)
    _assert_tables_equal(dev, ref)
    host = partition.build_partitions_numpy(keys_gn, codes_gn, block,
                                            wide=wide)
    _assert_tables_equal(host, jpartition.build_partitions_numpy(
        keys_gn, codes_gn, block, wide=wide))
    _assert_tables_equal(host, ref)
    assert (dev.num_groups, dev.num_partitions, dev.block_size) == \
        (g, -(-n // block), block)
    # numpy → tensors → numpy, and a JAX table carried across
    _assert_tables_equal(partition.table_to_numpy(
        partition.table_to(host, "cpu")), host)
    _assert_tables_equal(table_from_jax(ref), ref)


def test_build_partitions_single_partial_block(rng):
    _, codes, keys = _codes_keys(rng, 5, 2, 10, 2)
    keys_gn = np.ascontiguousarray(keys.T)
    codes_gn = np.ascontiguousarray(codes.transpose(1, 0, 2))
    ref = jpartition.build_partitions(jnp.asarray(keys_gn),
                                      jnp.asarray(codes_gn), 64)
    _assert_tables_equal(partition.build_partitions(
        torch.from_numpy(keys_gn), coding.words_to_torch(codes_gn), 64), ref)
