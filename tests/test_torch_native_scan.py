"""The port's native host scan (fspann_tpu_torch/ops/native_scan.py, built
from fspann_tpu/ops/native/hamming_topl.c) against the JAX package's
``native_scan`` and the port's torch scan.

Mirrors tests/test_native_scan.py: the kernel must be bit-interchangeable
with the device scan (same scores, same (score, id) order, same
RouteResult contract), and the index service must serve through it exactly
as the JAX index does."""

import dataclasses

import numpy as np
import pytest
import torch

from fspann_tpu.ops import native_scan as jnative
from fspann_tpu_torch import _build
from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops import hamming_scan as ths
from fspann_tpu_torch.ops import native_scan

torch.set_num_threads(1)

INF = np.iinfo(np.int32).max
FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")


def _mk(rng, n=500, d=24, m=10, lam=2, tables=2, divisions=2, q=9):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = rng.normal(size=(q, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m, lam, tables,
                                         divisions, 3)
    codes, _ = coding.encode_numpy(base, bank)
    qcodes, _ = coding.encode_numpy(queries, bank)
    return codes, qcodes, bank.code_bits


def _torch_scan(codes, qcodes, cb, dead, limit, **kw):
    qbits = torch.from_numpy(ths.unpack_bits_numpy(qcodes, cb))
    tomb = torch.from_numpy(np.zeros(len(codes), bool) if dead is None
                            else dead)
    return ths.scan(ths.build_scan_state(codes, cb), qbits, tomb, limit, **kw)


def _assert_same(a, b, fields=FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_library_builds_into_the_port():
    path = _build.native_scan_library_path()
    assert path == f"{_build.BUILD_DIR}/libfspann_scan.so"
    assert native_scan.available()


@pytest.mark.parametrize("margin", [0, 4])
def test_matches_jax_native_and_torch_scan(rng, margin):
    codes, qcodes, cb = _mk(rng, n=400)
    kw = dict(anchor=10, margin=margin, floor=5)
    got = native_scan.scan_topl(codes, qcodes, None, 50, **kw)
    assert isinstance(got.ids, np.ndarray)
    _assert_same(got, jnative.scan_topl(codes, qcodes, None, 50, **kw))
    _assert_same(got, _torch_scan(codes, qcodes, cb, None, 50, **kw))


def test_matches_chunked_scan_with_dead_mask(rng):
    codes, qcodes, cb = _mk(rng, n=300, q=5)
    dead = rng.random(300) < 0.3
    got = native_scan.scan_topl(codes, qcodes, dead, 40)
    _assert_same(got, jnative.scan_topl(codes, qcodes, dead, 40))
    qbits = torch.from_numpy(ths.unpack_bits_numpy(qcodes, cb))
    chunked = ths.scan_chunked(ths.build_scan_state_packed(codes, cb), qbits,
                               torch.from_numpy(dead), 40, chunk=64,
                               code_bits=cb)
    _assert_same(got, chunked, ("ids", "scores", "n_unique"))


def test_pads_when_l_exceeds_live(rng):
    codes, qcodes, _ = _mk(rng, n=60, q=3)
    dead = np.zeros(60, bool)
    dead[10:] = True          # 10 live rows, ask for 25
    ids, scores, n_live = native_scan.hamming_topl(codes, qcodes, dead, 25)
    jids, jscores, jn = jnative.hamming_topl(codes, qcodes, dead, 25)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(scores, jscores)
    assert n_live == jn == 10
    assert (ids[:, 10:] == -1).all() and (scores[:, 10:] == INF).all()
    assert (ids[:, :10] >= 0).all() and (ids[:, :10] < 10).all()
    for qi in range(3):
        key = scores[qi, :10].astype(np.int64) * 1000 + ids[qi, :10]
        assert (np.diff(key) > 0).all()


def test_adaptive_budget_matches_jax_and_device(rng):
    codes, qcodes, cb = _mk(rng, n=500, q=7)
    kw = dict(anchor=10, margin=3, floor=5)
    got = native_scan.scan_topl(codes, qcodes, None, 80, **kw)
    np.testing.assert_array_equal(
        got.n_dec, jnative.scan_topl(codes, qcodes, None, 80, **kw).n_dec)
    np.testing.assert_array_equal(
        got.n_dec, _torch_scan(codes, qcodes, cb, None, 80, **kw)
        .n_dec.numpy())
    scores = got.scores
    for a, m, f in ((10, 3, 5), (1, 0, 0), (200, 7, 90)):
        np.testing.assert_array_equal(
            native_scan._adaptive_count_numpy(scores, a, m, f, 80),
            jnative._adaptive_count_numpy(scores, a, m, f, 80))


def test_wide_codes_and_query_tails(rng):
    """w32 = 24 words (SIMD body + masked tail) and q = 11 (one 8-block +
    3 tail queries)."""
    codes, qcodes, cb = _mk(rng, n=350, d=48, m=40, lam=2, tables=4,
                            divisions=2, q=11)
    assert codes.shape[1] * codes.shape[2] == 24, codes.shape
    got = native_scan.scan_topl(codes, qcodes, None, 64)
    _assert_same(got, jnative.scan_topl(codes, qcodes, None, 64))
    _assert_same(got, _torch_scan(codes, qcodes, cb, None, 64))


def test_threads_do_not_change_results(rng):
    codes, qcodes, _ = _mk(rng, n=700, q=4)
    one = native_scan.hamming_topl(codes, qcodes, None, 64, threads=1)
    four = native_scan.hamming_topl(codes, qcodes, None, 64, threads=4)
    np.testing.assert_array_equal(one[0], four[0])
    np.testing.assert_array_equal(one[1], four[1])
    assert one[2] == four[2]


def test_thread_count_reads_the_environment(monkeypatch):
    monkeypatch.delenv("FSPANN_SCAN_THREADS", raising=False)
    monkeypatch.delenv("FSPANN_THREADS", raising=False)
    assert native_scan._num_threads() == jnative._num_threads() == 1
    monkeypatch.setenv("FSPANN_THREADS", "3")
    assert native_scan._num_threads() == 3
    monkeypatch.setenv("FSPANN_SCAN_THREADS", "bad")
    assert native_scan._num_threads() == 1


def _cfg(c, scan_native, **rt):
    cfg = c.SystemConfig()
    kw = dict(routing_mode="scan", refinement_limit=60, encode_backend="cpu",
              scan_native=scan_native, adaptive_decrypt_margin=4,
              adaptive_decrypt_anchor=10, adaptive_decrypt_floor=5)
    kw.update(rt)
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, **kw)).validate()


def _index_pair(rng, scan_native, n=300):
    """The same index in both packages (the JAX bank carried across), plus
    the port's index with the torch scan on the same bank."""
    from fspann_tpu import config as jconfig
    from fspann_tpu.index.service import PartitionedIndex as JIndex
    from fspann_tpu_torch import config as tconfig
    from fspann_tpu_torch.api.convert import bank_from_jax
    from fspann_tpu_torch.index.service import PartitionedIndex

    base = rng.normal(size=(n, 24)).astype(np.float32) * 4
    j = JIndex(_cfg(jconfig, scan_native), dim=24)
    j.stage(np.arange(n), base)
    j.finalize()
    jb = j.bank
    bank = bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                         np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                         jb.divisions, jb.seed)
    out = [j]
    for mode in (scan_native, "off"):
        t = PartitionedIndex(_cfg(tconfig, mode), dim=24, device="cpu")
        t.set_bank(bank)
        t.stage(np.arange(n), base)
        t.finalize()
        out.append(t)
    for ix in out:
        ix.mark_deleted([3, 17, 44])
    return out


@pytest.mark.parametrize("scan_native", ["on", "auto"])
def test_index_service_native_equals_jax_and_torch(rng, scan_native):
    """route_batch through the native kernel ("on", and "auto" on the CPU)
    == the JAX index's native route == the port's torch scan route."""
    j, t, off = _index_pair(rng, scan_native)
    assert t._scan_state is None and t._use_native_scan()
    assert off._scan_state is not None and not off._use_native_scan()
    queries = rng.normal(size=(6, 24)).astype(np.float32) * 4
    got = t.route_batch(*t.encode_queries(queries))
    assert isinstance(got.ids, np.ndarray)
    _assert_same(got, j.route_batch(*j.encode_queries(queries)))
    _assert_same(got, off.route_batch(*off.encode_queries(queries)))


def test_native_route_maps_sparse_ids(rng):
    """A non-dense id space maps the native route's rows to external ids,
    as the JAX index does."""
    from fspann_tpu import config as jconfig
    from fspann_tpu.index.service import PartitionedIndex as JIndex
    from fspann_tpu_torch import config as tconfig
    from fspann_tpu_torch.api.convert import bank_from_jax
    from fspann_tpu_torch.index.service import PartitionedIndex

    base = rng.normal(size=(200, 24)).astype(np.float32) * 4
    ids = np.arange(200) * 7 + 5
    j = JIndex(_cfg(jconfig, "on"), dim=24)
    j.stage(ids, base)
    j.finalize()
    jb = j.bank
    t = PartitionedIndex(_cfg(tconfig, "on"), dim=24, device="cpu")
    t.set_bank(bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                             np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                             jb.divisions, jb.seed))
    t.stage(ids, base)
    t.finalize()
    for ix in (j, t):
        ix.mark_deleted([12, 131])
    q = base[:5] + 0.01
    got = t.route_batch(*t.encode_queries(q))
    _assert_same(got, j.route_batch(*j.encode_queries(q)))
    assert got.ids[0, 0] == 5 and not np.isin(got.ids, [12, 131]).any()


def test_restore_preserves_native_results(rng, tmp_path):
    """save_table → fresh index → load_table: the native backend returns
    the same ranking from the restored packed codes, and no device state
    is built."""
    from fspann_tpu_torch import config as tconfig
    from fspann_tpu_torch.index.service import PartitionedIndex

    cfg = _cfg(tconfig, "on")
    base = rng.normal(size=(250, 24)).astype(np.float32) * 4
    queries = rng.normal(size=(5, 24)).astype(np.float32) * 4
    bank_p = str(tmp_path / "bank.npz")
    table_p = str(tmp_path / "table.npz")
    a = PartitionedIndex(cfg, dim=24, bank_path=bank_p, device="cpu")
    a.stage(np.arange(250), base)
    a.finalize()
    ra = a.route_batch(*a.encode_queries(queries))
    a.save_table(table_p)

    b = PartitionedIndex(cfg, dim=24, bank_path=bank_p, device="cpu")
    assert b.load_table(table_p, expect_rows=250)
    assert b._scan_state is None
    _assert_same(ra, b.route_batch(*b.encode_queries(queries)))


def test_scan_native_on_raises_when_the_library_cannot_build(rng,
                                                             monkeypatch):
    """scan_native="on" refuses to build an index the kernel cannot serve,
    and an index built for native-only serving refuses to fall back to a
    scan state it never built."""
    from fspann_tpu_torch import config as tconfig
    from fspann_tpu_torch.index.service import PartitionedIndex

    base = rng.normal(size=(120, 24)).astype(np.float32)
    served = PartitionedIndex(_cfg(tconfig, "auto"), dim=24, device="cpu")
    served.stage(np.arange(120), base)
    served.finalize()
    assert served._scan_state is None

    def broken():
        raise RuntimeError("building libfspann_scan.so failed")

    monkeypatch.setattr(native_scan, "_LIB", None)
    monkeypatch.setattr(native_scan, "native_scan_library_path", broken)
    assert not native_scan.available()
    idx = PartitionedIndex(_cfg(tconfig, "on"), dim=24, device="cpu")
    idx.stage(np.arange(120), base)
    with pytest.raises(RuntimeError, match="failed to build"):
        idx.finalize()
    qc = served.encode_queries(base[:2])
    with pytest.raises(RuntimeError, match="failed"):
        served.route_batch(*qc)        # no quiet switch to the torch scan
    served.cfg = _cfg(tconfig, "off")
    with pytest.raises(RuntimeError, match="native-only"):
        served.route_batch(*qc)
    # "auto" without the library keeps the torch scan on the CPU
    auto = PartitionedIndex(_cfg(tconfig, "auto"), dim=24, device="cpu")
    auto.stage(np.arange(120), base)
    auto.finalize()
    assert auto._scan_state is not None


def test_scan_native_config_validation():
    from fspann_tpu_torch.config import SystemConfig
    cfg = SystemConfig()
    with pytest.raises(ValueError, match="scan_native"):
        dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, scan_native="maybe")).validate()


def test_native_route_retry_matches_jax(tmp_path, rng):
    """The query service's scan-mode retry (widened decrypt budget) runs on
    the native route's numpy RouteResult as on JAX's: rows deleted in the
    store but still routed fail to decrypt, so the first pass underfills
    and the retry widens L."""
    from fspann_tpu import config as jconfig
    from fspann_tpu.api.system import ForwardSecureANNSystem as JaxSystem
    from fspann_tpu_torch import config as tconfig
    from fspann_tpu_torch.api.convert import bank_from_jax
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem

    def cfg(c):
        return _cfg(c, "on", adaptive_decrypt_margin=0, refinement_limit=40,
                    max_global_candidates=40)

    base = rng.normal(size=(600, 24)).astype(np.float32)
    queries = base[:4] + 0.01
    js = JaxSystem(cfg(jconfig), str(tmp_path / "jax"), 24, query_batch=4)
    ts = ForwardSecureANNSystem(cfg(tconfig), str(tmp_path / "torch"), 24,
                                query_batch=4, device="cpu")
    try:
        js.index_stream(base, batch_size=300)
        js.finalize_for_search()
        jb = js.index.bank
        ts.index.set_bank(bank_from_jax(
            np.asarray(jb.alpha), np.asarray(jb.r), np.asarray(jb.omega),
            jb.m, jb.lam, jb.tables, jb.divisions, jb.seed))
        ts.index_stream(base, batch_size=300)
        ts.finalize_for_search()
        assert ts.index._scan_state is None
        first = ts.index.route_batch(*ts.index.encode_queries(queries))
        gone = np.unique(first.ids[:, :30])
        for s in (js, ts):
            s.store.delete(gone)          # the index still routes them
        out = []
        for s in (js, ts):
            res = s.query_service.search_batches(
                [s.tokens.create_batch(queries, 10)])[0]
            out.append(res)
        a, b = out
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-6)
        assert [(s.retried, s.cand_decrypted) for s in b.stats] == \
            [(s.retried, s.cand_decrypted) for s in a.stats]
        assert all(s.retried for s in b.stats)
        assert not np.isin(b.ids, gone).any()
    finally:
        js.shutdown()
        ts.shutdown()
