"""The port's probe slice (``routing_mode="probe"``) against the JAX facade,
end to end, on the CPU at a small size (3k x 16, G = 6 groups of 64-bit
codes, block 32, default probes 5 and retry probes 10, f16 payloads,
query batch 16).

With ``encode_backend="cpu"`` and the JAX bank carried across
(``bank_from_jax``), codes, partition tables, routes and decrypt sets are
equal bit for bit, with and without the full-code re-rank and for narrow
and wide keys.  Both facades score on the host with the same C
decrypt-and-score kernel, so distances agree to float32 round-off (checked
at 1e-6 relative).  Device encode and device refine are checked against a
recall gate: device encode may flip bucket-boundary bits (at most 1e-4 of
them, tests/test_torch_coding.py), so the codes are not bit-equal to the
host encoder's."""

import dataclasses

import numpy as np
import pytest
import torch

from fspann_tpu import config as jconfig
from fspann_tpu.api.system import ForwardSecureANNSystem as JaxSystem
from fspann_tpu.io import groundtruth as jgt
from fspann_tpu.io import synthetic
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.index.service import PartitionedIndex
from fspann_tpu_torch.io import groundtruth as tgt

torch.set_num_threads(1)

N, D, NQ, BATCH = 3000, 16, 48, 16
FIELDS = ("ids", "scores", "n_unique", "n_raw")


def _cfg(c, rerank=0, wide="off", tables=2, block=32, limit=400):
    return c.SystemConfig(
        paper=c.PaperConfig(m=32, lam=2, divisions=3, tables=tables, seed=13),
        runtime=c.RuntimeConfig(refinement_limit=limit,
                                max_global_candidates=limit,
                                routing_mode="probe", encode_backend="cpu",
                                block_size=block, rerank_limit=rerank,
                                wide_keys=wide, storage_dtype="f16"),
        eval=c.EvalConfig(k_variants=(1, 10))).validate()


def _carry(js, ts):
    jb = js.index.bank
    ts.index.set_bank(bank_from_jax(
        np.asarray(jb.alpha), np.asarray(jb.r), np.asarray(jb.omega), jb.m,
        jb.lam, jb.tables, jb.divisions, jb.seed))


def _build_pair(root, base, **kw):
    js = JaxSystem(_cfg(jconfig, **kw), str(root / "jax"), D,
                   query_batch=BATCH)
    js.index_stream(base, batch_size=1000)
    js.finalize_for_search()
    ts = ForwardSecureANNSystem(_cfg(tconfig, **kw), str(root / "torch"), D,
                                query_batch=BATCH, device="cpu")
    _carry(js, ts)
    ts.index_stream(base, batch_size=1000)
    ts.finalize_for_search()
    return js, ts


@pytest.fixture(scope="module")
def corpus():
    return synthetic.lsh_hard_corpus(N, D, NQ, seed=7)


@pytest.fixture(scope="module", params=[(0, "off"), (150, "auto")],
            ids=["route-narrow", "rerank-wide"])
def pair(request, corpus, tmp_path_factory):
    rerank, wide = request.param
    root = tmp_path_factory.mktemp("probe")
    base, queries = corpus
    js, ts = _build_pair(root, base, rerank=rerank, wide=wide)
    yield js, ts, base, queries, root, dict(rerank=rerank, wide=wide)
    js.shutdown()
    ts.shutdown()


def _field(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_probe_route_per_batch_is_bit_identical(pair):
    js, ts, base, queries, _, kw = pair
    jt, tt = js.index._table_host, ts.index._table_host
    for f in jt._fields:
        a, b = getattr(jt, f), getattr(tt, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f)
    assert (tt.min_key2 is not None) == (kw["wide"] == "auto")
    assert (ts.index.point_codes is not None) == (kw["rerank"] > 0)
    for s in range(0, NQ, BATCH):
        jq = js.index.encode_queries(queries[s:s + BATCH])
        tq = ts.index.encode_queries(queries[s:s + BATCH])
        np.testing.assert_array_equal(tq[0], np.asarray(jq[0]))
        jr, tr = js.index.route_batch(*jq), ts.index.route_batch(*tq)
        for f in FIELDS:
            np.testing.assert_array_equal(_field(getattr(tr, f)),
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f)


def test_probe_results_decrypts_and_recall_match(pair):
    js, ts, base, queries, _, _ = pair
    jtok = [js.tokens.create_batch(queries[s:s + BATCH], 10)
            for s in range(0, NQ, BATCH)]
    ttok = [ts.tokens.create_batch(queries[s:s + BATCH], 10)
            for s in range(0, NQ, BATCH)]
    for a, b in zip(js.query_service.search_batches(jtok),
                    ts.query_service.search_batches(ttok)):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-6)
        for field in ("cand_decrypted", "cand_unique", "cand_raw",
                      "retried"):
            assert [getattr(s, field) for s in b.stats] == \
                [getattr(s, field) for s in a.stats], field
    jg = jgt.precompute(base, queries, k=10)
    tg = tgt.precompute(base, queries, k=10, backend="torch", device="cpu")
    ja = js.run_queries(queries, jg, base)
    ta = ts.run_queries(queries, tg, base)
    assert ta.recall_at_k == pytest.approx(ja.recall_at_k)
    assert ta.ratio_at_k == pytest.approx(ja.ratio_at_k, rel=1e-6)
    assert ta.mean_cand_decrypted == ja.mean_cand_decrypted
    assert ta.recall_at_k[10] > 0.3


def test_jax_table_npz_restores_in_port_and_routes_identically(pair):
    """The JAX facade wrote table.npz at finalize; the port reads it
    unchanged.  The port's own table.npz holds the same keys, dtypes and
    arrays."""
    js, ts, base, queries, root, kw = pair
    jpath = str(root / "jax" / "table.npz")
    jz, tz = np.load(jpath), np.load(str(root / "torch" / "table.npz"))
    assert sorted(jz.files) == sorted(tz.files)
    for key in jz.files:
        assert tz[key].dtype == jz[key].dtype, key
        np.testing.assert_array_equal(tz[key], jz[key], err_msg=key)
    idx = PartitionedIndex(_cfg(tconfig, **kw), D, device="cpu")
    _carry(js, type("S", (), {"index": idx}))
    assert idx.load_table(jpath, expect_rows=N)
    assert not idx.load_table(jpath, expect_rows=N + 1)
    jq = js.index.encode_queries(queries[:BATCH])
    jr, tr = js.index.route_batch(*jq), idx.route_batch(
        *(np.asarray(a) for a in jq))
    for f in FIELDS:
        np.testing.assert_array_equal(_field(getattr(tr, f)),
                                      np.asarray(getattr(jr, f)), err_msg=f)


def test_port_save_restore_search_round_trip(pair):
    _, ts, base, queries, root, kw = pair
    before = [[(r.id, r.distance) for r in ts.search(ts.create_token(q, 10))]
              for q in queries[:4]]
    ts.flush_all()
    back = ForwardSecureANNSystem(_cfg(tconfig, **kw), str(root / "torch"),
                                  D, query_batch=BATCH, device="cpu")
    try:
        assert back.restore_index_from_disk() == N
        assert back.index._table_host is not None      # the fast path
        after = [[(r.id, r.distance)
                  for r in back.search(back.create_token(q, 10))]
                 for q in queries[:4]]
        assert after == before
    finally:
        back.shutdown()


def test_default_probe_retry_fires_and_matches_jax(corpus, tmp_path):
    """G = 3 groups of 6-row blocks: 5 default probes reach at most 90
    candidates, fewer than the 10·K decrypt floor, so every query retries
    with 10 probes — in both facades alike."""
    base, queries = corpus
    js, ts = _build_pair(tmp_path, base, tables=1, block=6, limit=100)
    try:
        jr = js.query_service.search_batch(
            js.tokens.create_batch(queries[:BATCH], 10))
        tr = ts.query_service.search_batch(
            ts.tokens.create_batch(queries[:BATCH], 10))
        assert all(s.retried for s in tr.stats)
        assert [s.retried for s in tr.stats] == [s.retried for s in jr.stats]
        assert [s.cand_decrypted for s in tr.stats] == \
            [s.cand_decrypted for s in jr.stats]
        assert max(s.cand_decrypted for s in tr.stats) > 90
        np.testing.assert_array_equal(tr.ids, jr.ids)
    finally:
        js.shutdown()
        ts.shutdown()


def test_device_encode_and_device_refine_pass_recall_gate(corpus, tmp_path):
    base, queries = corpus
    cfg = _cfg(tconfig, rerank=150, wide="auto")
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, encode_backend="default", refine_backend="device"))
    ts = ForwardSecureANNSystem(cfg, str(tmp_path / "dev"), D,
                                query_batch=BATCH, device="cpu")
    try:
        ts.index_stream(base, batch_size=1000)
        ts.finalize_for_search()
        assert "table_build" in ts.index.finalize_sec
        assert ts.index._table_host is None             # built on device
        agg = ts.run_queries(queries, tgt.precompute(
            base, queries, k=10, backend="torch", device="cpu"), base)
        assert agg.recall_at_k[10] >= 0.8
        assert agg.mean_cand_decrypted == 150
    finally:
        ts.shutdown()


def test_default_config_serves_checkpoints_and_restores(corpus, tmp_path):
    """``SystemConfig()`` as shipped: probe routing, device encode, 5
    probes, retry 10, host refine."""
    base, queries = corpus
    cfg = tconfig.SystemConfig()
    rt = cfg.runtime
    assert (rt.routing_mode, rt.encode_backend, rt.effective_probes(),
            rt.retry_probes) == ("probe", "default", 5, 10)
    s = ForwardSecureANNSystem(cfg, str(tmp_path / "d"), D, device="cpu")
    try:
        s.index_stream(base[:2000], batch_size=500)
        s.finalize_for_search()
        hit = s.search(s.create_token(base[7] + 1e-3, 5))
        assert hit[0].id == 7
        before = [[r.id for r in s.search(s.create_token(q, 10))]
                  for q in queries[:3]]
        s.flush_all()
    finally:
        s.shutdown()
    back = ForwardSecureANNSystem(cfg, str(tmp_path / "d"), D, device="cpu")
    try:
        assert back.restore_index_from_disk() == 2000
        assert [[r.id for r in back.search(back.create_token(q, 10))]
                for q in queries[:3]] == before
    finally:
        back.shutdown()
