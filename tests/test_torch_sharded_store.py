"""The port's sharded host store (fspann_tpu_torch/store/sharded_store.py, a
carried copy) against the JAX package's: the same ids and vectors (numpy
seed) go into both, and every read, report and on-disk effect must agree.
Decrypted float32 payloads are compared exactly (both open the same bytes'
plaintext); fused norms within 1e-5 relative of the row's own norm, the JAX
tests' tolerance.  Mirrors tests/test_aux.py (sharded store cases) and
tests/test_distributed_serving.py (fused staging, threaded decrypt)."""

import os

import numpy as np
import pytest

from fspann_tpu.crypto.keys import KeyManager as JKeys
from fspann_tpu.store.sharded_store import ShardedPointStore as JStore
from fspann_tpu_torch.crypto.keys import KeyManager
from fspann_tpu_torch.store.sharded_store import ShardedPointStore


@pytest.fixture
def pair(tmp_path):
    """``make(dim, **kw)`` → (JAX store, port store), closed at teardown."""
    made = []

    def make(dim, **kw):
        jkm = JKeys(str(tmp_path / f"jks{len(made)}.blob"))
        km = KeyManager(str(tmp_path / f"tks{len(made)}.blob"))
        js = JStore(str(tmp_path / f"jdb{len(made)}"), jkm, dim, **kw)
        ts = ShardedPointStore(str(tmp_path / f"tdb{len(made)}"), km, dim,
                               **kw)
        made.extend([js, ts])
        return (js, jkm), (ts, km)

    yield make
    for s in made:
        s.close()


def test_sharded_store_roundtrip(pair, rng):
    (js, jkm), (ts, km) = pair(8, num_shards=3)
    ids = np.arange(100)
    vecs = rng.normal(size=(100, 8)).astype(np.float32)
    for s in (js, ts):
        s.insert_batch(ids, vecs)
    sizes = [len(sh.meta) for sh in ts.shards]
    assert sizes == [len(sh.meta) for sh in js.shards]
    assert all(sz > 0 for sz in sizes) and sum(sizes) == 100
    np.testing.assert_array_equal(ts.shard_of(ids), js.shard_of(ids))
    probe = np.array([5, 50, 99, -1])
    (jo, jok), (to, tok) = (s.load_decrypt_batch(probe) for s in (js, ts))
    assert tok.tolist() == jok.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(to[0], vecs[5], rtol=1e-6)
    for s in (js, ts):
        s.delete([5])
        assert not s.load_decrypt_batch(np.array([5]))[1][0]
    for k in (jkm, km):
        k.rotate()
    jrep, trep = (s.reencrypt_ids(np.arange(50)) for s in (js, ts))
    assert trep.reencrypted == jrep.reencrypted == 49   # id 5 deleted
    assert (trep.touched, trep.skipped_current, trep.failed) == \
        (jrep.touched, jrep.skipped_current, jrep.failed)
    assert ts.count_with_version(2) == js.count_with_version(2) == 49
    assert ts.size_bytes() == js.size_bytes()
    np.testing.assert_array_equal(np.sort(ts.meta.tombstoned_ids()),
                                  np.sort(js.meta.tombstoned_ids()))
    assert ts.undelete([5]) == js.undelete([5]) == [5]


def test_sharded_store_range_placement(pair, rng):
    (js, _), (ts, _) = pair(4, num_shards=4, placement="range")
    with pytest.raises(RuntimeError, match="set_range_size"):
        ts.shard_of(np.arange(3))
    vecs = rng.normal(size=(100, 4)).astype(np.float32)
    for s in (js, ts):
        s.set_range_size(25)
        s.insert_batch(np.arange(100), vecs)
    assert all(len(sh.meta) == 25 for sh in ts.shards)
    assert [len(sh.meta) for sh in js.shards] == [25] * 4
    # ids past the last range land on the last shard, as in JAX
    far = np.array([99, 100, 1000])
    np.testing.assert_array_equal(ts.shard_of(far), js.shard_of(far))


def test_sharded_store_retire_version_visits_every_shard(pair, rng):
    (js, jkm), (ts, km) = pair(8, num_shards=3)
    ids = np.arange(60)
    vecs = rng.normal(size=(60, 8)).astype(np.float32)
    for s in (js, ts):
        s.insert_batch(ids, vecs)
    shard = ts.shard_of(ids)
    assert all((shard == i).any() for i in range(3))
    for k in (jkm, km):
        k.rotate()
    for s in (js, ts):
        # migrate everything OFF v1 except shard 1's points
        s.reencrypt_ids(ids[shard != 1])
        assert not s.retire_version(1)   # shard 1 still owns live v1 points
        assert [os.path.exists(sh._arena_path(1)) for sh in s.shards] == \
            [False, True, False]
        s.reencrypt_ids(ids[shard == 1])
        assert s.retire_version(1)
        assert not os.path.exists(s.shards[1]._arena_path(1))


def test_sharded_store_probe_shards(pair, rng):
    (js, _), (ts, _) = pair(8, num_shards=4)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    for s in (js, ts):
        s.insert_batch(np.arange(64), vecs)
    assert ts.load_decrypt_batch(np.arange(64))[1].all()
    (jv, jok), (tv, tok) = (s.load_decrypt_batch(np.arange(64),
                                                 probe_shards=2)
                            for s in (js, ts))
    shard = ts.shard_of(np.arange(64))
    np.testing.assert_array_equal(tok, jok)
    assert (tok == (shard < 2)).all()
    np.testing.assert_array_equal(tv[tok], jv[jok])
    np.testing.assert_allclose(tv[tok], vecs[tok], rtol=1e-6)


def test_sharded_store_fused_staging_matches_plain(pair, rng):
    n, d = 512, 12
    (js, _), (ts, _) = pair(d, num_shards=4)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    for s in (js, ts):
        s.insert_batch(np.arange(n), vecs)
    ids = np.concatenate([rng.integers(0, n, 300), np.full(20, -1, np.int64)])
    outs = []
    for s in (js, ts):
        v0, ok0 = s.load_decrypt_batch(ids)
        out = np.zeros((len(ids), d), np.float32)
        norms = np.zeros(len(ids), np.float32)
        v1, ok1 = s.load_decrypt_batch(ids, out=out, norms_out=norms)
        assert v1 is out
        np.testing.assert_array_equal(ok0, ok1)
        np.testing.assert_array_equal(v0[ok0], out[ok1])
        np.testing.assert_allclose(
            norms[ok1], np.einsum("ij,ij->i", out[ok1], out[ok1]), rtol=1e-5)
        outs.append((out[ok1], ok1, norms[ok1]))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    # fused decrypt-and-score: the same (ok, norm, dot) from both packages
    q = rng.normal(size=(4, d)).astype(np.float32)
    flat = ids[:320].copy()
    scored = []
    for s in (js, ts):
        norms = np.full(len(flat), 7.0, np.float32)
        dots = np.full(len(flat), 7.0, np.float32)
        ok = s.load_score_batch(flat, q, 80, norms, dots, probe_shards=3)
        assert (norms[~ok] == 0).all() and (dots[~ok] == 0).all()
        scored.append((ok, norms, dots))
    for a, b in zip(*scored):
        np.testing.assert_array_equal(b, a)


def test_sharded_store_threaded_decrypt(pair, rng, monkeypatch):
    monkeypatch.setenv("FSPANN_SHARD_THREADS", "4")
    n, d = 1024, 8
    (js, _), (ts, _) = pair(d, num_shards=4)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.permutation(n)[:800]
    got = []
    for s in (js, ts):
        s.insert_batch(np.arange(n), vecs)
        out = np.zeros((len(ids), d), np.float32)
        norms = np.zeros(len(ids), np.float32)
        v, ok = s.load_decrypt_batch(ids, out=out, norms_out=norms)
        assert ok.all()
        np.testing.assert_allclose(v, vecs[ids], rtol=1e-6)
        np.testing.assert_allclose(
            norms, np.einsum("ij,ij->i", vecs[ids], vecs[ids]), rtol=1e-5)
        got.append((v, norms))
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_array_equal(got[1][1], got[0][1])
