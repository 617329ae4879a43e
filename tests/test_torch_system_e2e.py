"""The port's mirror of ``tests/test_system_e2e.py``: each full-pipeline
scenario (index → finalize → encrypted query → selective re-encryption →
restore) runs through the JAX facade and the port's (``device="cpu"``) on
the same seed-made corpus, with the JAX store's bank file (``torch_mirror``).

Compared: ids, decrypt counts, retries, touched and migrated sets and key
versions bit for bit; distances and ratios within ``DIST_RTOL`` = 1e-5
relative (the JAX file's own restore tolerance); recall exactly.  Each test
also keeps the JAX test's own assertions on the port's side."""

import dataclasses
import os

import numpy as np
import pytest

from fspann_tpu.io import groundtruth as jgt
from fspann_tpu_torch.io import groundtruth as tgt
from torch_mirror import (assert_same_aggregates, assert_same_results,
                          assert_same_search, built_pair, results, systems)

DIM = 16
N = 1500


def small_cfg(**runtime_kw):
    def build(c):
        return c.SystemConfig(
            paper=c.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
            runtime=c.RuntimeConfig(refinement_limit=600,
                                    max_global_candidates=600,
                                    block_size=32, **runtime_kw),
            eval=c.EvalConfig(k_variants=(1, 10))).validate()
    return build


@pytest.fixture
def corpus(rng):
    centers = rng.normal(size=(16, DIM)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, N)] + \
        rng.normal(size=(N, DIM)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 20)] + \
        rng.normal(size=(20, DIM)).astype(np.float32)
    return base, queries


def gts(base, queries, k=10):
    return (jgt.precompute(base, queries, k=k),
            tgt.precompute(base, queries, k=k, backend="torch",
                           device="cpu"))


def shutdown(*systems_):
    for s in systems_:
        s.shutdown()


def test_full_pipeline(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 400)
    try:
        assert ts.index.size == js.index.size == N
        jg, tg = gts(base, queries)
        np.testing.assert_array_equal(tg.gt, jg.gt)
        agg = ts.run_queries(queries, tg, base)
        assert_same_aggregates(agg, js.run_queries(queries, jg, base))
        assert agg.num_queries == 20 and agg.recall_at_k[10] > 0.9
        assert agg.ratio_at_k[10] < 1.05 and agg.mean_cand_decrypted > 0
        res = ts.search(ts.create_token(queries[0], 5))
        assert_same_search(res, js.search(js.create_token(queries[0], 5)))
        assert len(res) == 5
        d0 = np.linalg.norm(base[res[0].id] - queries[0])
        assert abs(res[0].distance - d0) < 1e-3
    finally:
        shutdown(js, ts)


def test_query_before_finalize_raises(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base[:1200], 600,
                        finalize=False)
    try:
        for s in (js, ts):
            with pytest.raises(Exception, match="finaliz"):
                s.search(s.create_token(queries[0], 5))
    finally:
        shutdown(js, ts)


@pytest.mark.parametrize("bad", ["width", "nan"])
def test_dimension_mismatch_raises(tmp_path, bad):
    js, make = systems(small_cfg(), tmp_path, DIM)
    ts = make()
    try:
        vecs = np.zeros((5, DIM + (bad == "width")), np.float32)
        if bad == "nan":
            vecs[0, 0] = np.nan
        for s in (js, ts):
            with pytest.raises(ValueError):
                s.batch_insert(np.arange(5), vecs)
    finally:
        shutdown(js, ts)


def test_selective_reencryption_and_query_stability(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        jg, tg = gts(base, queries)
        r1 = ts.run_queries(queries, tg, base)
        assert_same_aggregates(r1, js.run_queries(queries, jg, base))
        rep = ts.run_selective_reencryption()
        jrep = js.run_selective_reencryption()
        for f in ("reencrypted", "old_version", "new_version"):
            assert rep[f] == jrep[f], f
        assert rep["reencrypted"] > 0 and rep["new_version"] == 2
        ts.profiler.clear_rows()
        js.profiler.clear_rows()
        r2 = ts.run_queries(queries, tg, base)
        assert_same_aggregates(r2, js.run_queries(queries, jg, base))
        assert r2.recall_at_k[10] == pytest.approx(r1.recall_at_k[10],
                                                   abs=1e-9)
    finally:
        shutdown(js, ts)


def test_deletion_excluded_from_results(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        res = ts.search(ts.create_token(queries[0], 10))
        assert_same_search(res, js.search(js.create_token(queries[0], 10)))
        victim = res[0].id
        for s in (js, ts):
            s.delete([victim])
        res2 = ts.search(ts.create_token(queries[0], 10))
        assert_same_search(res2, js.search(js.create_token(queries[0], 10)))
        assert victim not in [r.id for r in res2]
    finally:
        shutdown(js, ts)


def test_restore_from_disk(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    before = ts.search(ts.create_token(queries[0], 10))
    shutdown(js, ts)
    js, make = systems(small_cfg(), tmp_path, DIM)
    ts = make()
    try:
        assert ts.restore_index_from_disk() == js.restore_index_from_disk() \
            == N
        res = ts.search(ts.create_token(queries[0], 10))
        assert_same_search(res, js.search(js.create_token(queries[0], 10)))
        assert_same_search(res, before)
    finally:
        shutdown(js, ts)


def test_export_artifacts(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        jg, tg = gts(base, queries[:5])
        made = []
        for s, g, out in ((js, jg, "jres"), (ts, tg, "tres")):
            s.run_queries(queries[:5], g, base)
            s.run_selective_reencryption()
            s.export_artifacts(str(tmp_path / out))
            made.append(sorted(os.listdir(tmp_path / out)))
        assert made[1] == made[0]
        for f in ("profiler_metrics.csv", "summary.csv", "accuracy.csv",
                  "cost.csv", "metrics_summary.txt", "reencrypt_metrics.csv"):
            assert f in made[1], f
        with open(tmp_path / "jres" / "accuracy.csv") as a, \
                open(tmp_path / "tres" / "accuracy.csv") as b:
            assert b.read().splitlines()[0] == a.read().splitlines()[0]
    finally:
        shutdown(js, ts)


def test_adaptive_retry_triggers(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(probe_override=1, retry_probes=6),
                        tmp_path, DIM, base, 500)
    try:
        dead = np.arange(0, N, dtype=np.int64)[:-(N // 10)]
        jg, tg = gts(base, queries)
        for s, g in ((js, jg), (ts, tg)):
            s.delete(dead)
            s.run_queries(queries, g)
        retried = [(r.query_index, r.k) for r in ts.profiler.rows
                   if r.retried]
        assert retried, "expected at least one adaptive retry"
        assert retried == [(r.query_index, r.k) for r in js.profiler.rows
                           if r.retried]
    finally:
        shutdown(js, ts)


def test_system_level_forward_security_game(tmp_path, corpus):
    from fspann_tpu_torch.crypto import aesgcm
    from fspann_tpu_torch.types import aad_for

    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        stolen = aesgcm.GcmKey(ts.km.get_version(1).key)
        for s in (js, ts):
            s.search(s.create_token(queries[0], 10))
        touched = ts.tracker.unique_count()
        assert touched == js.tracker.unique_count() and touched > 10
        rep = ts.run_selective_reencryption()
        assert rep["reencrypted"] == js.run_selective_reencryption()[
            "reencrypted"] == touched
        migrated = [pid for pid in range(N)
                    if ts.store.key_version_of(pid) == 2]
        assert migrated == [pid for pid in range(N)
                            if js.store.key_version_of(pid) == 2]
        assert len(migrated) == touched
        opened = 0
        for pid in migrated[:50]:
            m = ts.store.meta.get(pid)
            _rid, _kv, _dim, iv, ct = ts.store._reader(2).read_record(
                m.arena_off)
            for v in (1, 2):
                try:
                    stolen.open(iv, ct, aad_for(pid, v, DIM))
                    opened += 1
                except ValueError:
                    pass
        assert opened == 0
        assert ts.store.meta.count_with_version(1) == N - touched
    finally:
        shutdown(js, ts)


@pytest.mark.parametrize("backend", ["cpu", "default"])
def test_cpu_encode_backend_equivalent(tmp_path, corpus, backend):
    """Host encode (``cpu``) and the device encoders on the CPU: the same
    codes, ids and recall in both packages."""
    base, queries = corpus
    js, ts = built_pair(small_cfg(encode_backend=backend), tmp_path, DIM,
                        base, 500)
    try:
        np.testing.assert_array_equal(
            ts.index.encode_queries(queries)[0],
            np.asarray(js.index.encode_queries(queries)[0]))
        jg, tg = gts(base, queries)
        agg = ts.run_queries(queries, tg, base)
        assert_same_aggregates(agg, js.run_queries(queries, jg, base))
        assert agg.recall_at_k[10] > 0.9
    finally:
        shutdown(js, ts)


def test_fast_restore_from_table(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    before = ts.search(ts.create_token(queries[0], 10))
    shutdown(js, ts)
    for sub in ("jax", "torch"):
        assert os.path.exists(tmp_path / sub / "table.npz")
    js, make = systems(small_cfg(), tmp_path, DIM)
    ts = make()
    try:
        assert ts.restore_index_from_disk() == js.restore_index_from_disk() \
            == N
        assert ts.index._staged == js.index._staged == 0    # fast path
        res = ts.search(ts.create_token(queries[0], 10))
        assert_same_search(res, js.search(js.create_token(queries[0], 10)))
        assert [r.id for r in res] == [r.id for r in before]
    finally:
        shutdown(js, ts)

    # a different block size rejects the table: the slow path re-stages
    def cfg3(c):
        cfg = small_cfg(probe_override=2)(c)
        return dataclasses.replace(
            cfg, paper=dataclasses.replace(cfg.paper, seed=99))

    def cfg4(c):
        cfg = cfg3(c)
        return dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime, block_size=16))

    js, ts = built_pair(cfg3, tmp_path / "s3", DIM, base, 500)
    shutdown(js, ts)
    js, make = systems(cfg4, tmp_path / "s3", DIM)
    ts = make()
    try:
        assert ts.restore_index_from_disk() == js.restore_index_from_disk() \
            == N
        assert ts.index._n_rows == js.index._n_rows == N
        assert_same_search(ts.search(ts.create_token(queries[1], 10)),
                           js.search(js.create_token(queries[1], 10)))
    finally:
        shutdown(js, ts)


def test_fast_restore_reseeds_tombstones(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    victim = ts.search(ts.create_token(queries[0], 5))[0].id
    assert victim == js.search(js.create_token(queries[0], 5))[0].id
    for s in (js, ts):
        s.delete([victim])
    shutdown(js, ts)
    js, make = systems(small_cfg(), tmp_path, DIM)
    ts = make()
    try:
        for s in (js, ts):
            s.restore_index_from_disk()
            assert s.index._staged == 0 and victim in s.index._deleted
        res = ts.search(ts.create_token(queries[0], 5))
        assert_same_search(res, js.search(js.create_token(queries[0], 5)))
        assert victim not in [r.id for r in res]
    finally:
        shutdown(js, ts)


def test_finalize_idempotent(tmp_path, corpus):
    base, _ = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        table = ts.index.table
        ts.finalize_for_search()     # no-op, no error
        js.finalize_for_search()
        assert ts.index.size == js.index.size == N
        assert ts.index.table is table
    finally:
        shutdown(js, ts)


def test_token_under_deleted_key_version_rejected(tmp_path, corpus):
    from fspann_tpu.query.service import StaleTokenError as JStale
    from fspann_tpu_torch.query.service import StaleTokenError

    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        for s, err in ((js, JStale), (ts, StaleTokenError)):
            old_tok = s.create_token(queries[0], 5)
            s.rotation.force_rotate_now()
            s.store.reencrypt_all()
            s.rotation.force_rotate_now()
            assert s.rotation.finalize_rotation() == [1]
            with pytest.raises(err, match="retired or unknown"):
                s.search(old_tok)
        res = ts.search(ts.create_token(queries[0], 5))
        assert_same_search(res, js.search(js.create_token(queries[0], 5)))
        assert len(res) == 5
    finally:
        shutdown(js, ts)


def test_undelete_restores_visibility(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        victim = ts.search(ts.create_token(queries[0], 5))[0].id
        for s in (js, ts):
            s.delete([victim])
            assert victim not in [
                r.id for r in s.search(s.create_token(queries[0], 5))]
            assert s.undelete([victim]) == [victim]
        res = ts.search(ts.create_token(queries[0], 5))
        assert_same_search(res, js.search(js.create_token(queries[0], 5)))
        assert res[0].id == victim
    finally:
        shutdown(js, ts)


def test_query_cache_does_not_alias_nearby_queries(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(), tmp_path, DIM, base, 500)
    try:
        q1 = queries[0]
        q2 = q1 + 1e-4
        t1, t2 = ts.create_token(q1, 5), ts.create_token(q2, 5)
        assert np.array_equal(t1.codes, t2.codes), "test premise: same codes"
        np.testing.assert_array_equal(t1.codes,
                                      np.asarray(js.create_token(q1, 5).codes))
        r1, r2 = ts.search(t1), ts.search(t2)
        assert [r.distance for r in r1] != [r.distance for r in r2]
        assert_same_search(r1, js.search(js.create_token(q1, 5)))
        assert_same_search(r2, js.search(js.create_token(q2, 5)))
        r1b = ts.search(ts.create_token(q1, 5))
        assert [r.id for r in r1b] == [r.id for r in r1]
        assert ts.metrics.counters.get("query.cache_hits") == 1
    finally:
        shutdown(js, ts)


def test_rerank_pipeline_recall_and_budget(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(small_cfg(rerank_limit=150), tmp_path, DIM, base,
                        400)
    try:
        jg, tg = gts(base, queries)
        agg = ts.run_queries(queries, tg, base)
        assert_same_aggregates(agg, js.run_queries(queries, jg, base))
        assert agg.mean_cand_decrypted <= 150
        assert agg.recall_at_k[10] > 0.85
    finally:
        shutdown(js, ts)


def test_rerank_fast_restore_roundtrip(tmp_path, corpus):
    base, queries = corpus
    cfg = small_cfg(rerank_limit=150)
    js, ts = built_pair(cfg, tmp_path, DIM, base, 400)
    before = results(ts, queries, 10)
    assert_same_results(before, results(js, queries, 10))
    for s in (js, ts):
        s.flush_all()
    shutdown(js, ts)
    js, make = systems(cfg, tmp_path, DIM)
    ts = make()
    try:
        for s in (js, ts):
            assert s.restore_index_from_disk()
            assert s.index.point_codes is not None
        after = results(ts, queries, 10)
        assert_same_results(after, before)
        assert_same_results(after, results(js, queries, 10))
    finally:
        shutdown(js, ts)


@pytest.mark.parametrize("dtype", ["f32", "f16"])
def test_fused_score_matches_device_refine(tmp_path, corpus, dtype):
    """The port's host (fused decrypt-and-score) and device refines against
    each other at the JAX test's tolerance (1e-4), and each against the
    JAX package's same backend (ids bit for bit, distances 1e-5)."""
    base, queries = corpus
    got = {}
    for backend in ("host", "device"):
        js, ts = built_pair(
            small_cfg(refine_backend=backend, storage_dtype=dtype),
            tmp_path / backend, DIM, base, 400)
        try:
            got[backend] = results(ts, queries, 10)
            assert_same_results(got[backend], results(js, queries, 10))
        finally:
            shutdown(js, ts)
    (ids_h, d_h, _), (ids_d, d_d, _) = got["host"], got["device"]
    np.testing.assert_allclose(d_h, d_d, rtol=1e-4, atol=1e-4)
    assert (ids_h == ids_d).mean() > 0.95
