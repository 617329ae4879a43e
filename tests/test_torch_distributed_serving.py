"""The port's distributed encrypted facade
(fspann_tpu_torch/parallel/serving.py) against the JAX package's, on the CPU:
8 JAX CPU devices (tests/conftest.py) against 8 row ranges of one CPU tensor.

Every test is one scenario, run through both facades on the same inputs
(numpy seed); everything it returns is compared: integer arrays (final ids,
assigned ids, counts) bit for bit, distances to 1e-6 relative (both score
on the host with the same C decrypt-and-score kernel; the JAX tests use the
same tolerance between two runs of one facade).

Both facades draw their bank inside ``build``, each from its own
``build_bank_from_sample``, which give the same bank bit for bit
(tests/test_torch_coding.py); the ``grid_banks`` fixture then rounds
``alpha`` to multiples of 2^-10 in both, so that with vectors on the 1/16
grid every projection is exact in float32 and the two device encoders
agree bit for bit whatever their summation order
(tests/test_torch_sharded.py asserts that premise on the codes).  Both
facades serve their scan with ``approx=True``, the default, which XLA:CPU
and the port compute exactly on the CPU.

Mirrors tests/test_distributed_serving.py (facade tests) and
tests/test_i8_storage.py::test_mesh_i8_scan_recall_and_stream_equality."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu import config as jconfig
from fspann_tpu.crypto.keys import KeyManager as JKeys
from fspann_tpu.crypto.rotation import BackgroundReencryption as JDaemon
from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import refine as jrefine
from fspann_tpu.parallel import serving as jserving
from fspann_tpu.parallel.sharded import ShardedIndex as JIndex
from fspann_tpu.parallel.sharded import make_mesh as jmake_mesh
from fspann_tpu.store.sharded_store import ShardedPointStore as JStore
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.crypto.keys import KeyManager
from fspann_tpu_torch.crypto.rotation import BackgroundReencryption
from fspann_tpu_torch.ops import refine as trefine
from fspann_tpu_torch.parallel import serving as tserving
from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh
from fspann_tpu_torch.store.sharded_store import ShardedPointStore

torch.set_num_threads(1)

DIST_RTOL = 1e-6
ND = 8


def _grid(x):
    return (np.round(np.asarray(x, np.float64) * 16) / 16).astype(np.float32)


@pytest.fixture
def grid_banks(monkeypatch):
    """Each facade draws its own bank (equal bit for bit), with ``alpha``
    then put on the 2^-10 grid in both, where the two device encoders'
    summation orders give the same codes."""
    def on_grid(build):
        def grid_build(*args, **kw):
            b = build(*args, **kw)
            alpha = (np.round(np.asarray(b.alpha, np.float64) * 1024)
                     / 1024).astype(np.float32)
            return dataclasses.replace(b, alpha=alpha)
        return grid_build

    for coding in (jserving.coding, tserving.coding):
        monkeypatch.setattr(coding, "build_bank_from_sample",
                            on_grid(coding.build_bank_from_sample))


class _Side:
    """One package's names for a scenario."""

    def __init__(self, name, root):
        self.jax = name == "jax"
        self.root = root / name
        self.c = jconfig if self.jax else tconfig

    def cfg(self, **rt):
        c = self.c
        return c.SystemConfig(
            paper=c.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
            runtime=c.RuntimeConfig(**rt)).validate()

    def scan_cfg(self, **rt):
        return self.cfg(**{**dict(refinement_limit=512,
                                  max_global_candidates=512, block_size=32,
                                  routing_mode="scan"), **rt})

    def system(self, cfg, d, tag="db"):
        if self.jax:
            return jserving.DistributedEncryptedSystem(
                cfg, str(self.root / tag), d)
        return tserving.DistributedEncryptedSystem(
            cfg, str(self.root / tag), d, mesh=make_mesh(ND, device="cpu"))

    def daemon(self, *a, **kw):
        return (JDaemon if self.jax else BackgroundReencryption)(*a, **kw)


def _compare(a, b, path="out"):
    """JAX's output ``a`` against the port's ``b``."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _compare(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_allclose(b, a, rtol=DIST_RTOL, err_msg=path)
    elif isinstance(a, np.ndarray):
        assert b.dtype == a.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert a == b, path


def _both(scenario, tmp_path):
    out = [scenario(_Side(name, tmp_path)) for name in ("jax", "torch")]
    _compare(*out)
    return out[1]


def _clusters(rng, n=2048, d=16, q=6, centers=16, spread=5.0):
    c = rng.normal(size=(centers, d)).astype(np.float32) * spread
    base = c[rng.integers(0, centers, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = c[rng.integers(0, centers, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)
    return _grid(base), _grid(queries)


def _recall(ids, base, queries, k):
    d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :k]
    return sum(len(set(ids[i].tolist()) & set(gt[i].tolist()))
               for i in range(len(queries))) / (len(queries) * k)


def test_sharded_encrypted_pipeline(tmp_path, rng):
    """Route on the sharded index, decrypt candidates from the shard-aligned
    encrypted store, refine — the parts the facade composes, by hand."""
    n, d, q, k, cand_k = 2048, 16, 6, 10, 64
    base, queries = _clusters(rng, n, d, q)
    jb = jcoding.build_bank_from_sample(base[:1000], m=8, lam=2, tables=3,
                                        divisions=2, seed=13)
    jb = dataclasses.replace(jb, alpha=(np.round(
        np.asarray(jb.alpha, np.float64) * 1024) / 1024).astype(np.float32))

    def scenario(side):
        if side.jax:
            idx = JIndex(jmake_mesh(), jb, block_size=32)
            km = JKeys(str(side.root / "ks"))
            Store = JStore
        else:
            idx = ShardedIndex(make_mesh(ND, device="cpu"), bank_from_jax(
                np.asarray(jb.alpha), np.asarray(jb.r), np.asarray(jb.omega),
                jb.m, jb.lam, jb.tables, jb.divisions, jb.seed),
                block_size=32)
            km = KeyManager(str(side.root / "ks"))
            Store = ShardedPointStore
        idx.build(base)
        store = Store(str(side.root / "db"), km, d, num_shards=ND,
                      placement="range")
        try:
            store.set_range_size(idx.shard_rows)
            store.insert_batch(np.arange(n), base)
            ids, _ = idx.query(queries, probes=3, refinement_limit=256,
                               k=cand_k)
            ids = np.asarray(ids)
            flat = ids.reshape(-1)
            vecs, ok = store.load_decrypt_batch(flat)
            valid = ok.reshape(q, cand_k)
            assert valid[ids >= 0].all()
            cand = vecs.reshape(q, cand_k, d)
            if side.jax:
                res = jrefine.refine(jnp.asarray(queries), jnp.asarray(cand),
                                     jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(valid), k)
                got = np.asarray(res.ids)
            else:
                res = trefine.refine(
                    torch.from_numpy(queries), torch.from_numpy(cand),
                    torch.from_numpy(ids.astype(np.int32)),
                    torch.from_numpy(valid), k)
                got = res.ids.numpy()
            km.rotate()
            rep = store.reencrypt_ids(np.arange(0, n, 2))
            vecs2, ok2 = store.load_decrypt_batch(flat)
            assert (ok2 == ok).all()
            np.testing.assert_allclose(vecs2, vecs, rtol=1e-6)
            return dict(cand=ids, final=got.astype(np.int64),
                        reencrypted=rep.reencrypted)
        finally:
            store.close()

    out = _both(scenario, tmp_path)
    assert out["reencrypted"] == n // 2
    assert _recall(out["final"], base, queries, k) > 0.9


def test_distributed_encrypted_system_facade(tmp_path, rng, grid_banks):
    n, d, q, k = 2048, 16, 6, 10
    base, queries = _clusters(rng, n, d, q)

    def scenario(side):
        sys_ = side.system(side.cfg(refinement_limit=512,
                                    max_global_candidates=512,
                                    default_probes=4, block_size=32), d)
        try:
            sys_.build(base)
            assert sys_.index.base is None        # no plaintext on the device
            first = sys_.search_batch(queries, k)
            rep = sys_.rotate_and_migrate()
            again = sys_.search_batch(queries, k)
            np.testing.assert_array_equal(first[0], again[0])
            np.testing.assert_allclose(first[1], again[1], rtol=1e-6)
            sub = sys_.search_batch(queries, k, probe_shards=2)
            live = sub[0][sub[0] >= 0]
            assert (live < 2 * sys_.index.shard_rows).all()
            return dict(first=first, reencrypted=rep.reencrypted, sub=sub,
                        rows=sys_.index.shard_rows)
        finally:
            sys_.close()

    out = _both(scenario, tmp_path)
    assert out["first"][0].shape == (q, k)
    assert out["first"][0].dtype == np.int64
    assert out["reencrypted"] == n
    assert _recall(out["first"][0], base, queries, k) > 0.9


@pytest.mark.parametrize("mode", ["probe", "scan"])
def test_distributed_system_rerank_and_scan_recall(tmp_path, rng,
                                                   grid_banks, mode):
    """``rerank_limit`` truncates the probe route's decrypt set per shard;
    in scan mode it is moot (the scan ranks by the full code already)."""
    n, d, q, k = 2048, 16, 6, 10
    base, queries = _clusters(rng, n, d, q)

    def scenario(side):
        sys_ = side.system(side.cfg(refinement_limit=600,
                                    max_global_candidates=600, block_size=32,
                                    rerank_limit=200, routing_mode=mode), d)
        try:
            sys_.build(base)
            assert (sys_.index.point_codes is not None) == (mode == "probe")
            assert (sys_.index.bits is not None) == (mode == "scan")
            return sys_.search_batch(queries, k)
        finally:
            sys_.close()

    ids, _ = _both(scenario, tmp_path)
    assert ids.shape == (q, k)
    assert _recall(ids, base, queries, k) > 0.9


def test_distributed_index_stream_encrypted(tmp_path, rng, grid_banks):
    n, d, q, k = 2048, 16, 6, 10
    base, queries = _clusters(rng, n, d, q)

    def scenario(side):
        sys_ = side.system(side.scan_cfg(), d)
        try:
            def gen():
                for i in range(0, n, 300):
                    yield base[i:i + 300]

            assert sys_.index_stream(gen(), n_total=n) == n
            rows = sys_.index.shard_rows
            per_shard = [len(s.meta) for s in sys_.store.shards]
            assert per_shard == [max(0, min(n - s * rows, rows))
                                 for s in range(ND)]
            return dict(res=sys_.search_batch(queries, k), rows=rows)
        finally:
            sys_.close()

    out = _both(scenario, tmp_path)
    assert _recall(out["res"][0], base, queries, k) >= 0.9
    with pytest.raises(ValueError, match="n_total"):
        _Side("torch", tmp_path / "x").system(
            _Side("torch", tmp_path).scan_cfg(), d).index_stream(iter([]))


def test_distributed_insert_live_searchable_and_rotatable(tmp_path, rng,
                                                          grid_banks):
    n, d, k = 1600, 16, 5
    base, _ = _clusters(rng, n, d, 1, centers=12, spread=6.0)
    new = _grid(np.full((40, d), 30.0) + rng.normal(size=(40, d)))
    q = np.full((1, d), 30.0, np.float32)

    def scenario(side):
        sys_ = side.system(side.scan_cfg(), d)
        try:
            sys_.build(base, capacity=2400)
            ids = sys_.insert_live(new)
            assert ids[0] == n and sys_.n == n + 40
            got = sys_.search_batch(q, k)
            assert set(got[0][0].tolist()) <= set(ids.tolist())
            rep = sys_.rotate_and_migrate(np.arange(sys_.n))
            again = sys_.search_batch(q, k)
            np.testing.assert_array_equal(got[0], again[0])
            return dict(ids=ids, got=got, reencrypted=rep.reencrypted)
        finally:
            sys_.close()

    assert _both(scenario, tmp_path)["reencrypted"] > 0
    probe = _Side("torch", tmp_path / "p")
    sys_ = probe.system(probe.cfg(block_size=32), d)
    try:
        with pytest.raises(RuntimeError, match="routing_mode='scan'"):
            sys_.insert_live(new)
    finally:
        sys_.close()


def test_distributed_facade_checkpoint_restore(tmp_path, rng, grid_banks):
    n, d, k = 1200, 16, 5
    base = _grid(rng.normal(size=(n, d)) * 4)
    queries = _grid(base[rng.integers(0, n, 4)]
                    + rng.normal(size=(4, d)) * 0.1)

    def scenario(side):
        s1 = side.system(side.scan_cfg(), d, "ck")
        try:
            s1.build(base)
            before = s1.search_batch(queries, k)
            s1.save_index()
        finally:
            s1.close()
        s2 = side.system(side.scan_cfg(), d, "ck")
        try:
            assert s2.restore_index() == n
            after = s2.search_batch(queries, k)
            np.testing.assert_array_equal(before[0], after[0])
            return before
        finally:
            s2.close()

    _both(scenario, tmp_path)


def test_mesh_deletion_excluded_and_restored(tmp_path, rng, grid_banks):
    n, d, k = 1200, 16, 5
    base = _grid(rng.normal(size=(n, d)) * 4)
    q = _grid(base[7:8] + rng.normal(size=(1, d)) * 0.01)
    new = _grid(np.full((10, d), 25.0) + rng.normal(size=(10, d)))

    def scenario(side):
        out = {}
        sys_ = side.system(side.scan_cfg(), d, "del")
        try:
            sys_.build(base, capacity=1600)
            out["0"] = sys_.search_batch(q, k)
            assert 7 in out["0"][0][0].tolist()
            sys_.delete(np.array([7]))
            out["1"] = sys_.search_batch(q, k)
            assert 7 not in out["1"][0][0].tolist()
            sys_.save_index()
        finally:
            sys_.close()
        back = side.system(side.scan_cfg(), d, "del")
        try:
            back.restore_index()
            out["2"] = back.search_batch(q, k)
            assert 7 not in out["2"][0][0].tolist()
            nids = back.insert_live(new)
            out["3"] = back.search_batch(np.full((1, d), 25.0, np.float32), k)
            assert set(out["3"][0][0].tolist()) <= set(nids.tolist())
            out["4"] = back.search_batch(q, k)
            assert 7 not in out["4"][0][0].tolist()
            return out
        finally:
            back.close()

    _both(scenario, tmp_path)


def test_mesh_background_migration_daemon(tmp_path, rng, grid_banks):
    n, d, k = 800, 16, 5
    base = _grid(rng.normal(size=(n, d)) * 4)
    queries = _grid(base[rng.integers(0, n, 4)]
                    + rng.normal(size=(4, d)) * 0.05)

    def scenario(side):
        sys_ = side.system(side.scan_cfg(), d)
        try:
            sys_.build(base)
            before = sys_.search_batch(queries, k)
            v0 = sys_.km.current_version
            sys_.rotation.rotate_key_only()      # all ciphertexts now stale
            assert sys_.migration_remaining(v0) == n
            daemon = side.daemon(sys_.rotation, interval_s=60, batch=300)
            moved = []
            while sys_.migration_remaining(v0) > 0:
                moved.append(daemon.run_once())
                assert moved[-1] > 0
            after = sys_.search_batch(queries, k)
            np.testing.assert_array_equal(before[0], after[0])
            return dict(before=before, moved=moved)
        finally:
            sys_.close()

    assert sum(_both(scenario, tmp_path)["moved"]) == n


def test_mesh_undelete_roundtrip(tmp_path, rng, grid_banks):
    n, d, k = 800, 16, 5
    base = _grid(rng.normal(size=(n, d)) * 4)
    q = _grid(base[11:12] + rng.normal(size=(1, d)) * 0.01)

    def scenario(side):
        sys_ = side.system(side.scan_cfg(), d)
        try:
            sys_.build(base)
            sys_.delete(np.array([11]))
            gone = sys_.search_batch(q, k)
            assert 11 not in gone[0][0].tolist()
            restored = sys_.undelete(np.array([11]))
            back = sys_.search_batch(q, k)
            assert 11 in back[0][0].tolist()
            return dict(gone=gone, restored=restored, back=back)
        finally:
            sys_.close()

    assert _both(scenario, tmp_path)["restored"] == [11]


def test_mesh_checkpoint_after_live_insert(tmp_path, rng):
    """save_state after append_scan_rows checkpoints the APPENDED rows
    (stale kept codes are dropped; codes repack from the live bit matrix).
    The port's file restores through its own ``restore_state``; the JAX file
    is the same apart from ``alpha``."""
    n, d = 800, 16
    base = _grid(rng.normal(size=(n + 100, d)) * 3)
    jb = jcoding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    jb = dataclasses.replace(jb, alpha=(np.round(
        np.asarray(jb.alpha, np.float64) * 1024) / 1024).astype(np.float32))
    bank = bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                         np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                         jb.divisions, jb.seed)
    queries = base[n + 3:n + 7]
    files = {}

    def scenario(side):
        idx = JIndex(jmake_mesh(), jb, block_size=16) if side.jax \
            else ShardedIndex(make_mesh(ND, device="cpu"), bank, block_size=16)
        idx.build(base[:n], keep_base=False, keep_bits=True, keep_codes=True,
                  capacity=1024)
        idx.append_scan_rows(base[n:])
        assert idx.point_codes is None
        side.root.mkdir(parents=True, exist_ok=True)
        path = str(side.root / "live_ck.npz")
        idx.save_state(path)
        files[side.jax] = dict(np.load(path))
        kw = dict(approx=False) if side.jax else {}
        a = idx.scan_route(queries, limit=32, **kw)
        back = type(idx).restore_state(path, idx.mesh)
        assert back.n == n + 100
        b = back.scan_route(queries, limit=32, **kw)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        # (the JAX scores come back int64 under its x64 switch; the port's
        # are int32 by contract)
        return [np.asarray(x).astype(np.int32) for x in a]

    ids, _ = _both(scenario, tmp_path)
    assert (ids[:, 0] == np.arange(n + 3, n + 7)).all()
    for key, want in files[True].items():
        np.testing.assert_array_equal(files[False][key], want, err_msg=key)


def test_mesh_compact_storage_reclaims(tmp_path, rng, grid_banks):
    n, d, k = 600, 16, 5
    base = _grid(rng.normal(size=(n, d)) * 4)
    q = base[3:4]

    def scenario(side):
        sys_ = side.system(side.scan_cfg(), d)
        try:
            sys_.build(base)
            before = sys_.size_bytes()
            sys_.rotate_and_migrate(np.arange(0, n, 2))
            bloated = sys_.size_bytes()
            assert bloated > before
            rep = sys_.compact_storage()
            assert rep["bytes_freed"] > 0
            assert rep["storage_bytes"] < bloated
            got = sys_.search_batch(q, k)
            assert 3 in got[0][0].tolist()
            return dict(before=before, bloated=bloated, rep=rep, got=got)
        finally:
            sys_.close()

    _both(scenario, tmp_path)


def test_mesh_adaptive_decrypt_budget(tmp_path, rng, grid_banks):
    n, d, q, k = 2048, 16, 8, 10
    base, queries = _clusters(rng, n, d, q)

    def scenario(side):
        cfg = side.scan_cfg()
        sys_ = side.system(cfg, d)
        decrypted = []
        orig = sys_.store.load_score_batch   # the fused stage-B entry point

        def counting(flat, *a, **kw):
            decrypted.append(int((np.asarray(flat) >= 0).sum()))
            return orig(flat, *a, **kw)

        sys_.store.load_score_batch = counting

        def with_margin(margin):
            sys_.cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
                cfg.runtime, adaptive_decrypt_margin=margin)).validate()

        try:
            sys_.build(base)
            off = sys_.search_batch(queries, k)
            with_margin(10_000)        # saturated: n_dec == L everywhere
            sat = sys_.search_batch(queries, k)
            np.testing.assert_array_equal(off[0], sat[0])
            np.testing.assert_allclose(off[1], sat[1])
            assert decrypted[1] == decrypted[0]
            with_margin(2)             # tight: score-competitive set only
            on = sys_.search_batch(queries, k)
            assert decrypted[2] < decrypted[0]
            return dict(off=off, on=on, decrypted=decrypted)
        finally:
            sys_.close()

    out = _both(scenario, tmp_path)
    r_off = _recall(out["off"][0], base, queries, k)
    assert _recall(out["on"][0], base, queries, k) >= r_off - 1 / k


def test_mesh_packed_facade_and_checkpoint(tmp_path, rng, grid_banks):
    n, d, q, k = 900, 16, 5, 10
    base = _grid(rng.normal(size=(n, d)) * 4)
    queries = _grid(base[rng.integers(0, n, q)]
                    + rng.normal(size=(q, d)) * 0.05)

    def scenario(side):
        s_off = side.system(side.scan_cfg(scan_packed="off"), d, "off")
        s_on = side.system(side.scan_cfg(scan_packed="on"), d, "on")
        try:
            s_off.build(base)
            s_on.build(base)
            assert s_on.index.words is not None and s_on.index.bits is None
            assert s_off.index.bits is not None and s_off.index.words is None
            r0 = s_off.search_batch(queries, k)
            r1 = s_on.search_batch(queries, k)
            np.testing.assert_array_equal(r0[0], r1[0])
            np.testing.assert_allclose(r0[1], r1[1], rtol=1e-6)
            s_on.save_index()
            s_on.index = None
            assert s_on.restore_index() == n
            assert s_on.index.words is not None and s_on.index.bits is None
            r2 = s_on.search_batch(queries, k)
            np.testing.assert_array_equal(r1[0], r2[0])
            return r0
        finally:
            s_off.close()
            s_on.close()

    _both(scenario, tmp_path)
    # "auto" on the CPU compares ALL the shards' rows (they share one
    # device) with the 4 GiB fallback: unpacked at this size
    side = _Side("torch", tmp_path / "auto")
    s = side.system(side.scan_cfg(scan_packed="auto"), d)
    try:
        assert s._scan_layout(100) is True
        assert s._scan_layout((4 << 30) // (ND * 48) + 1) == "packed"
    finally:
        s.close()


@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_mesh_search_batches_pipelined_matches_sequential(tmp_path, rng,
                                                          grid_banks, mode):
    n, d, k = 1536, 16, 8
    base = _grid(rng.normal(size=(n, d)) * 3)
    batches = [_grid(base[rng.integers(0, n, 5)]
                     + rng.normal(size=(5, d)) * 0.05) for _ in range(3)]
    extra = dict(adaptive_decrypt_margin=6, adaptive_decrypt_anchor=8,
                 adaptive_decrypt_floor=32) if mode == "scan" else {}

    def scenario(side):
        sys_ = side.system(side.cfg(refinement_limit=256,
                                    max_global_candidates=256,
                                    default_probes=4, block_size=32,
                                    routing_mode=mode, **extra), d)
        try:
            sys_.build(base)
            seq = [sys_.search_batch(b, k) for b in batches]
            piped = sys_.search_batches(batches, k)
            assert len(piped) == len(seq)
            for (i1, d1), (i2, d2) in zip(seq, piped):
                np.testing.assert_array_equal(i1, i2)
                np.testing.assert_allclose(d1, d2, rtol=1e-6)
            return seq
        finally:
            sys_.close()

    _both(scenario, tmp_path)
    with pytest.raises(RuntimeError, match="build"):
        side = _Side("torch", tmp_path / "nb")
        side.system(side.scan_cfg(), d).search_batch(batches[0], k)


@pytest.mark.parametrize("packed", ["off", "on"])
def test_mesh_merge_host_and_ici_differ_in_nothing(tmp_path, rng,
                                                   grid_banks, packed):
    """``runtime.mesh_merge`` reaches the index (its first reader is the
    facade) and both merges serve the JAX facade's results."""
    n, d, q, k = 1500, 16, 6, 10
    base, queries = _clusters(rng, n, d, q)
    seen = {}

    def scenario_for(merge):
        def scenario(side):
            sys_ = side.system(side.scan_cfg(mesh_merge=merge,
                                             scan_packed=packed), d, merge)
            try:
                sys_.build(base, capacity=n + 100)
                assert sys_.index.merge_backend == merge
                sys_.delete(np.arange(0, n, 97))
                out = sys_.search_batch(queries, k)
                sys_.save_index()
                sys_.index = None
                sys_.restore_index()
                assert sys_.index.merge_backend == merge
                again = sys_.search_batch(queries, k)
                np.testing.assert_array_equal(out[0], again[0])
                return out
            finally:
                sys_.close()
        return scenario

    for merge in ("ici", "host"):
        seen[merge] = _both(scenario_for(merge), tmp_path)
    np.testing.assert_array_equal(seen["ici"][0], seen["host"][0])
    np.testing.assert_array_equal(seen["ici"][1], seen["host"][1])
    with pytest.raises(ValueError, match="mesh_merge"):
        _Side("torch", tmp_path).scan_cfg(mesh_merge="nvlink")


def test_mesh_i8_scan_recall_and_stream_equality(tmp_path, rng, grid_banks):
    """i8 payloads: the facade quantizes through the storage dtype BEFORE
    encoding.  The quantized vectors leave the exact grid, so the two
    device encoders may differ on a boundary bit; the final ids are held
    equal all the same (a flipped code bit moves a candidate's rank by one
    score step, far from deciding a top-10 by exact distance)."""
    n, d, q, k = 2048, 16, 6, 10
    base, queries = _clusters(rng, n, d, q)

    def scenario(side):
        cfg = side.cfg(refinement_limit=600, max_global_candidates=600,
                       block_size=32, routing_mode="scan",
                       storage_dtype="i8")
        s1, s2 = side.system(cfg, d, "one"), side.system(cfg, d, "str")
        try:
            assert s1.store.dtype == "i8"
            s1.build(base)
            one = s1.search_batch(queries, k)
            s2.index_stream((base[s:s + 512] for s in range(0, n, 512)),
                            n_total=n)
            streamed = s2.search_batch(queries, k)
            np.testing.assert_array_equal(one[0], streamed[0])
            np.testing.assert_allclose(one[1], streamed[1], rtol=1e-6)
            return one
        finally:
            s1.close()
            s2.close()

    ids, _ = _both(scenario, tmp_path)
    assert _recall(ids, base, queries, k) > 0.9
