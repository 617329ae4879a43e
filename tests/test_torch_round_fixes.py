"""The port's mirror of ``tests/test_round3_fixes.py``,
``tests/test_round4_fixes.py`` and ``tests/test_round5_fixes.py``: the
hardening regressions of rounds 3-5 (scan retry, rotation pinning,
checkpoint validation, tracker and profiler contracts, kadaptive, decoys,
the 24-bit id transfer, the table checkpoint's host twin), each run through
the port (``device="cpu"``) and, where the scenario serves queries, through
the JAX package on the same seed-made inputs and bank (``torch_mirror``).

Compared: ids, route calls, retries, decrypt and touched counts bit for bit;
distances and ratios within 1e-5 relative.  The JAX tests' own assertions
hold on the port's side."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.io import groundtruth as jgt
from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import partition as jpartition
from fspann_tpu.ops import routing as jrouting
from fspann_tpu.query import service as jservice
from fspann_tpu_torch.api.multidim import MultiDimSystem
from fspann_tpu_torch.crypto.rotation import (ReencryptionTracker,
                                              RotationRefused)
from fspann_tpu_torch.io import groundtruth as tgt
from fspann_tpu_torch.ops import coding, partition, routing
from fspann_tpu_torch.query import service as tservice
from torch_mirror import (assert_same_aggregates, assert_same_results,
                          assert_same_search, built_pair, results, systems)

DIM = 16
N = 1200


def scan_cfg(**runtime_kw):
    def build(c):
        kw = dict(refinement_limit=400, max_global_candidates=400,
                  block_size=32, routing_mode="scan")
        kw.update(runtime_kw)
        return c.SystemConfig(
            paper=c.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
            runtime=c.RuntimeConfig(**kw),
            eval=c.EvalConfig(k_variants=(1, 10))).validate()
    return build


@pytest.fixture
def corpus(rng):
    centers = rng.normal(size=(16, DIM)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, N)] + \
        rng.normal(size=(N, DIM)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 8)] + \
        rng.normal(size=(8, DIM)).astype(np.float32)
    return base, queries


def shutdown(*systems_):
    for s in systems_:
        s.shutdown()


class RouteRecorder:
    """Wraps index.route_batch, recording (probes, refinement_limit)."""

    def __init__(self, index):
        self.calls = []
        self._orig = index.route_batch
        index.route_batch = self._wrapped

    def _wrapped(self, qc, qk, probes=None, refinement_limit=None):
        self.calls.append((probes, refinement_limit))
        return self._orig(qc, qk, probes, refinement_limit)


# -- round 3 ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["widens", "skipped"])
def test_scan_retry(tmp_path, corpus, case):
    """An underfilled scan query retries ONCE with a widened decrypt budget
    (``widens``), and not at all when L already covers every live row
    (``skipped``); both packages make the same route calls and results."""
    base, queries = corpus
    if case == "widens":
        cfg = scan_cfg()
    else:
        cfg = scan_cfg(refinement_limit=4096, max_global_candidates=4096)
    js, ts = built_pair(cfg, tmp_path, DIM, base, 600)
    try:
        got = []
        for s in (js, ts):
            if case == "widens":
                s.store.delete(np.arange(40, N))   # store side only
            else:
                s.delete(np.arange(5, N))
            rec = RouteRecorder(s.index)
            res = s.query_service.search_batch(
                [s.create_token(q, 10) for q in queries[:4]])
            got.append((rec.calls, res))
        (jcalls, jres), (calls, res) = got
        assert calls == jcalls
        np.testing.assert_array_equal(res.ids, jres.ids)
        np.testing.assert_allclose(res.distances, jres.distances, rtol=1e-5)
        if case == "widens":
            eff = ts.cfg.runtime.effective_refinement()
            assert len(calls) == 2 and calls[0][1] is None
            assert calls[1][1] == 2 * eff
            assert all(s.retried for s in res.stats)
        else:
            assert len(calls) == 1
            assert not any(s.retried for s in res.stats)
    finally:
        shutdown(js, ts)


def test_tracker_drain_sorted_single_part():
    from fspann_tpu.crypto.rotation import ReencryptionTracker as JTracker

    for t in (JTracker(), ReencryptionTracker()):
        t.record(np.array([9, 3, 7, 3], np.int64))
        assert t.unique_count() == 3
        assert t.drain() == [3, 7, 9]
        assert t.drain() == []


def test_force_rotate_refused_when_pinned(tmp_path, corpus):
    base, _ = corpus
    _, make = systems(scan_cfg(), tmp_path, DIM)
    ts = make()
    try:
        ts.index_stream(base[:200], batch_size=200)
        ts.finalize_for_search()
        ts.rotation.activate_version(ts.km.current_version)
        with pytest.raises(RotationRefused):
            ts.rotation.force_rotate_now()
        assert ts.run_selective_reencryption().get("skipped") is True
    finally:
        ts.shutdown()


def test_multidim_pinned_refuses_global_rotation(tmp_path, corpus):
    from fspann_tpu_torch import config as tconfig

    base, _ = corpus
    md = MultiDimSystem(scan_cfg()(tconfig), str(tmp_path / "md"),
                        device="cpu")
    try:
        md.batch_insert(np.arange(200), base[:200])
        md.finalize_for_search()
        v0 = md.km.current_version
        md.system_for(DIM).rotation.activate_version(v0)
        assert md.run_selective_reencryption().get("skipped") is True
        assert md.km.current_version == v0
    finally:
        md.shutdown()


def test_load_table_rejects_mismatched_point_codes(tmp_path, corpus):
    base, queries = corpus
    js, ts = built_pair(scan_cfg(), tmp_path, DIM, base, 600)
    for s in (js, ts):
        path = s.index.table_path
        z = dict(np.load(path))
        z["point_codes"] = z["point_codes"][: N // 2]     # truncate
        np.savez(path.removesuffix(".npz"), **z)
    shutdown(js, ts)
    js, make = systems(scan_cfg(), tmp_path, DIM)
    ts = make()
    try:
        for s in (js, ts):
            assert not s.index.load_table(s.index.table_path, expect_rows=N)
            assert s.restore_index_from_disk() == N
        res = ts.search(ts.create_token(queries[0], 5))
        assert len(res) == 5
        assert_same_search(res, js.search(js.create_token(queries[0], 5)))
    finally:
        shutdown(js, ts)


def test_route_rerank_pads_rank_last(rng):
    """Pad slots score INT32_MAX and rank after every live candidate, with
    ``approx=True`` as the JAX test runs it (pads take the 2^30 sentinel
    there, not INT32_MAX) and with the exact default; both equal JAX's."""
    n, d = 300, 24
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    jb = jcoding.build_bank_from_sample(base[:256], 10, 2, 2, 2, 3)
    bank = coding.GBank(np.asarray(jb.alpha), np.asarray(jb.r),
                        np.asarray(jb.omega), 10, 2, 2, 2, 3)
    queries = rng.normal(size=(4, d)).astype(np.float32) * 4
    tomb = np.ones(n, bool)
    tomb[:20] = False

    jc, jk = jcoding.encode(jnp.asarray(base), jb)
    jt = jpartition.build_partitions(jnp.transpose(jk, (1, 0)),
                                     jnp.transpose(jc, (1, 0, 2)), 16)
    jqc, jqk = jcoding.encode(jnp.asarray(queries), jb)

    c, k = coding.encode(torch.from_numpy(base), bank)
    t = partition.build_partitions(k.T.contiguous(),
                                   c.transpose(0, 1).contiguous(), 16)
    qc, qk = coding.encode(torch.from_numpy(queries), bank)
    args = (t, qc, qk, torch.from_numpy(tomb), c, 2, 64)
    for approx in (True, False):
        want = jrouting.route_rerank(jt, jqc, jqk, jnp.asarray(tomb),
                                     jnp.asarray(jc), 2, 64, approx=approx)
        res = routing.route_rerank(*args, approx=approx)
        ids, scores = res.ids.numpy(), res.scores.numpy()
        np.testing.assert_array_equal(ids, np.asarray(want.ids))
        np.testing.assert_array_equal(scores, np.asarray(want.scores))
        np.testing.assert_array_equal(res.n_unique.numpy(),
                                      np.asarray(want.n_unique))
        assert (scores[ids < 0] == np.iinfo(np.int32).max).all()
        assert (ids < 0).any(), "no pad slot to rank"
        for qi in range(ids.shape[0]):
            live = np.flatnonzero(ids[qi] >= 0)
            if len(live):
                assert live.max() == len(live) - 1, "pad ranked above live"


@pytest.mark.parametrize("enabled", [True, False])
def test_kadaptive(tmp_path, enabled):
    from fspann_tpu_torch.config import KAdaptiveConfig

    def cfg(c):
        base_cfg = scan_cfg()(c)
        if not enabled:
            return base_cfg
        return dataclasses.replace(base_cfg, kadaptive=c.KAdaptiveConfig(
            enabled=True, probe_factor=2.0, max_fanout=16))

    js, make = systems(cfg, tmp_path, DIM)
    ts = make()
    try:
        assert isinstance(ts.cfg.kadaptive, KAdaptiveConfig)
        steps = [(ts.kadaptive_widen(), js.kadaptive_widen())
                 for _ in range(2)]
        assert all(a == b for a, b in steps)
        assert ts.kadaptive_probe_enabled() is enabled
        if enabled:
            assert [a for a, _ in steps] == [(5, 10), (10, 16)]
            assert ts.query_service.cfg is ts.cfg
        else:
            assert [a for a, _ in steps] == [(5, 5), (5, 5)]
        assert ts.cfg.runtime.effective_probes() == \
            js.cfg.runtime.effective_probes()
    finally:
        shutdown(js, ts)


def test_decoy_interleaving_preserves_real_metrics(tmp_path, corpus):
    from fspann_tpu.query.decoy import DecoyGenerator as JDecoys
    from fspann_tpu_torch.query.decoy import DecoyGenerator

    base, queries = corpus
    jg = jgt.precompute(base, queries, k=10)
    tg = tgt.precompute(base, queries, k=10, backend="torch", device="cpu")
    plain = built_pair(scan_cfg(), tmp_path / "plain", DIM, base, 600)
    cloak = built_pair(scan_cfg(), tmp_path / "cloak", DIM, base, 600)
    try:
        mixed, src = DecoyGenerator(DIM, rate=1.0, seed=7).interleave(
            queries)
        jmixed, jsrc = JDecoys(DIM, rate=1.0, seed=7).interleave(queries)
        np.testing.assert_array_equal(mixed, jmixed)
        np.testing.assert_array_equal(src, jsrc)
        assert (src >= 0).sum() == len(queries)
        aggs = []
        for (js, ts), kw in ((plain, {}), (cloak, {"real_src": src})):
            q = queries if not kw else mixed
            a = ts.run_queries(q, tg, base, **kw)
            assert_same_aggregates(a, js.run_queries(q, jg, base, **kw))
            assert ts.tracker.unique_count() == js.tracker.unique_count()
            aggs.append((a, ts.tracker.unique_count()))
        (agg0, touched0), (agg1, touched1) = aggs
        assert agg1.num_queries == agg0.num_queries == len(queries)
        assert agg1.recall_at_k[10] == pytest.approx(agg0.recall_at_k[10])
        assert agg1.ratio_at_k[10] == pytest.approx(agg0.ratio_at_k[10])
        assert touched1 > touched0
        diag = cloak[1].diagnostics
        assert diag.total == len(queries)
        assert all(0 <= e.query_index < len(queries) for e in diag.samples)
    finally:
        shutdown(*plain, *cloak)


def test_aggregates_from_profiler_matches_from_rows(tmp_path, corpus):
    from fspann_tpu_torch.query.aggregates import Aggregates

    base, queries = corpus
    js, ts = built_pair(scan_cfg(), tmp_path, DIM, base, 600)
    try:
        tg = tgt.precompute(base, queries, k=10, backend="torch",
                            device="cpu")
        a_fast = ts.run_queries(queries, tg, base)
        assert_same_aggregates(a_fast, js.run_queries(
            queries, jgt.precompute(base, queries, k=10), base))
        a_rows = Aggregates.from_rows(ts.profiler.rows)
        assert a_fast.num_queries == a_rows.num_queries
        assert a_fast.mean_art_ms == pytest.approx(a_rows.mean_art_ms)
        assert a_fast.p95_art_ms == pytest.approx(a_rows.p95_art_ms)
        for k in a_rows.recall_at_k:
            assert a_fast.recall_at_k[k] == pytest.approx(
                a_rows.recall_at_k[k])
            assert a_fast.ratio_at_k[k] == pytest.approx(
                a_rows.ratio_at_k[k])
        assert a_fast.retry_fraction == pytest.approx(a_rows.retry_fraction)
    finally:
        shutdown(js, ts)


def test_scan_flat_budget_knob(tmp_path, corpus):
    """A 1 MiB budget puts the port's scan on the chunked path; results
    equal the flat scan's and the JAX package's."""
    base, queries = corpus
    flat = built_pair(scan_cfg(scan_native="off"), tmp_path / "f", DIM,
                      base, 600)
    chunked = built_pair(scan_cfg(scan_native="off", scan_flat_budget_mb=1),
                         tmp_path / "c", DIM, base, 600)
    try:
        assert chunked[1].index._scan_flat_budget() == 1 << 20
        want = results(flat[0], queries, 10)
        for _js, ts in (flat, chunked):
            assert_same_results(results(ts, queries, 10), want)
    finally:
        shutdown(*flat, *chunked)


def test_fspann_threads_batch_open_identical(tmp_path, rng, monkeypatch):
    from fspann_tpu_torch.crypto.keys import KeyManager
    from fspann_tpu_torch.store.point_store import PointStore

    n, d = 2000, 24
    store = PointStore(str(tmp_path / "st"),
                       KeyManager(str(tmp_path / "ks.blob")), d)
    store.insert_batch(np.arange(n), rng.normal(size=(n, d)).astype(
        np.float32))
    try:
        ids = rng.permutation(n)[:1500]
        got = []
        for threads in ("1", "2"):
            monkeypatch.setenv("FSPANN_THREADS", threads)
            norms = np.zeros(len(ids), np.float32)
            v, ok = store.load_decrypt_batch(ids, norms_out=norms)
            assert ok.all()
            got.append((v, norms))
        np.testing.assert_array_equal(got[0][0], got[1][0])
        np.testing.assert_array_equal(got[0][1], got[1][1])
    finally:
        store.close()


def test_profiler_rows_external_clear_cannot_desync():
    from fspann_tpu_torch.utils.profiler import ROW_FIELDS, Profiler

    p = Profiler()
    blk = {f: np.zeros(3) for f in ROW_FIELDS}
    blk["query_index"] = np.arange(3)
    p.record_block(**blk)
    assert len(p.rows) == 3
    p.rows.clear()
    assert len(p.rows) == 3
    p.clear_rows()
    assert len(p.rows) == 0
    p.record_block(**blk)
    assert len(p.rows) == 3


# -- round 4: the 24-bit id transfer ---------------------------------------------

def test_pack24_matches_jax_at_the_edges():
    ids = np.array([[-1, 0, 1, 255, 256, 65535, 65536,
                     tservice._PACK24_MAX]], np.int32)
    assert tservice._PACK24_MAX == jservice._PACK24_MAX
    packed = tservice._pack24(torch.from_numpy(ids)).numpy()
    assert packed.shape == (1, 8, 3) and packed.dtype == np.uint8
    np.testing.assert_array_equal(
        packed, np.asarray(jservice._pack24(jnp.asarray(ids))))
    np.testing.assert_array_equal(tservice._unpack24(packed), ids)


def test_pack24_random_roundtrip_matches_jax(rng):
    ids = rng.integers(-1, tservice._PACK24_MAX + 1,
                       size=(7, 513)).astype(np.int32)
    packed = tservice._pack24(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jservice._pack24(jnp.asarray(ids))))
    np.testing.assert_array_equal(tservice._unpack24(packed), ids)


@pytest.mark.parametrize("flag", [None, "1", "0", "off"])
def test_pack_transfer_switch(monkeypatch, flag):
    """``FSPANN_PACK24`` forces the packing either way; unset, ids on a
    device pack and ids on the CPU do not."""
    if flag is None:
        monkeypatch.delenv("FSPANN_PACK24", raising=False)
    else:
        monkeypatch.setenv("FSPANN_PACK24", flag)
    for dev in ("cpu", "cuda", "meta"):
        want = dev != "cpu" if flag is None else flag == "1"
        assert tservice._pack_transfer_enabled(torch.device(dev)) is want


@pytest.mark.parametrize("flag", ["1", "0"])
def test_packed_transfer_results_identical(tmp_path, rng, monkeypatch, flag):
    """With FSPANN_PACK24 on and off, the port serves the JAX package's
    results bit for bit (and so the same results either way)."""
    base = rng.normal(size=(3000, 16)).astype(np.float32)
    queries = base[:8] + 0.01 * rng.normal(size=(8, 16)).astype(np.float32)
    monkeypatch.setenv("FSPANN_PACK24", flag)
    packs = []
    real = tservice._pack24

    def spy(x):
        packs.append(x.shape)
        return real(x)

    monkeypatch.setattr(tservice, "_pack24", spy)
    cfg = scan_cfg(rerank_limit=200, refinement_limit=512,
                   max_global_candidates=512, scan_native="off",
                   adaptive_decrypt_margin=40, block_size=64)
    js, ts = built_pair(cfg, tmp_path, 16, base, 1000)
    try:
        got = results(ts, queries, 10)
        assert_same_results(got, results(js, queries, 10))
        np.testing.assert_array_equal(got[1], results(js, queries, 10)[1])
        assert (got[0] >= 0).all()
        assert bool(packs) is (flag == "1")
    finally:
        shutdown(js, ts)


def test_short_open_path_boundaries(tmp_path, rng):
    """The aggregated short-record GCM open (records up to 128 GHASH
    blocks) agrees with the generic path in the port's build of the C
    library: dims around the boundary and odd partial-block bodies."""
    from fspann_tpu_torch.crypto.keys import KeyManager
    from fspann_tpu_torch.store.point_store import PointStore

    km = KeyManager(str(tmp_path / "ks"))
    for dim, dtype in ((1, "f32"), (3, "i8"), (31, "f16"), (128, "f32"),
                       (500, "f32"), (600, "f32")):
        vecs = rng.normal(size=(17, dim)).astype(np.float32)
        s = PointStore(str(tmp_path / f"db_{dim}_{dtype}"), km, dim=dim,
                       dtype=dtype)
        s.insert_batch(np.arange(17), vecs)
        out, ok = s.load_decrypt_batch(np.arange(17))
        assert ok.all()
        np.testing.assert_allclose(out, s.quantize(vecs), rtol=1e-3,
                                   atol=1e-3)
        s.close()


# -- round 5: the table checkpoint's host twin --------------------------------------

def _r5_cfg(**runtime_kw):
    return scan_cfg(encode_backend="cpu", **runtime_kw)


def _same_bits(a, b):
    """Equal arrays, compared as bit patterns (a table's ``rep_codes`` are
    uint32 on the host and int32 patterns on the device)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (a, b))
    np.testing.assert_array_equal(a.view(b.dtype) if a.dtype != b.dtype
                                  else a, b)


@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_save_table_host_twin_matches_device(tmp_path, corpus, mode):
    base, queries = corpus
    cfg = _r5_cfg(routing_mode=mode,
                  rerank_limit=200 if mode == "probe" else 0)
    js, ts = built_pair(cfg, tmp_path, DIM, base, 600)
    try:
        idx = ts.index
        assert idx._table_host is not None
        for h, d, j in zip(idx._table_host, idx.table, js.index._table_host):
            _same_bits(h, d)
            _same_bits(h, j)
        if mode == "probe":
            np.testing.assert_array_equal(
                idx._codes_host, coding.words_to_numpy(idx.point_codes))
            np.testing.assert_array_equal(idx._codes_host,
                                          js.index._codes_host)
        _, make = systems(cfg, tmp_path, DIM)
        fresh = make()
        try:
            assert fresh.index.load_table(idx.table_path, expect_rows=N)
            for h, d, h0 in zip(fresh.index._table_host, fresh.index.table,
                                idx._table_host):
                _same_bits(h, d)
                _same_bits(h, h0)
            res = fresh.search(fresh.create_token(queries[0], 5))
            assert len(res) == 5
            assert_same_search(res, js.search(js.create_token(queries[0], 5)))
        finally:
            fresh.shutdown()
    finally:
        shutdown(js, ts)


def test_save_table_does_not_pull_device_table(tmp_path, corpus):
    base, _ = corpus
    _, make = systems(_r5_cfg(), tmp_path, DIM)
    ts = make()
    try:
        ts.index_stream(base, batch_size=600)
        ts.finalize_for_search()
        idx = ts.index
        idx.table = idx.table._replace(ids=torch.full_like(idx.table.ids,
                                                           -7))
        idx.save_table(idx.table_path)
        z = np.load(idx.table_path)
        np.testing.assert_array_equal(z["ids"],
                                      np.asarray(idx._table_host.ids))
        assert not (z["ids"] == -7).all()
    finally:
        ts.shutdown()
