"""The port's scan lifecycle against the JAX package, on the CPU at a small
size: the packed scan state and the row update (ops), capacity-padded
builds, live inserts in place and past capacity, deletes, rotation with
re-encryption and restore (index and facade), and the facade lifecycle and
forward-security games on the port alone.

Both packages hold the same bank (the JAX bank carried across with
``bank_from_jax``) and encode on the host, so codes and scan routes are
equal bit for bit; both score candidates with the same C decrypt-and-score
kernel, so distances agree to float32 round-off (checked at 1e-6 relative)
and the decrypted counts are equal.

Mirrors tests/test_scan_capacity.py, the live-insert, delete and packed
tests of tests/test_hamming_scan.py, tests/test_lifecycle.py and the G1-G6
games of tests/test_forward_security.py."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fspann_tpu import config as jconfig
from fspann_tpu.api.system import ForwardSecureANNSystem as JaxSystem
from fspann_tpu.ops import hamming_scan as jhs
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops import hamming_scan as ths

torch.set_num_threads(1)

FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")
N, D, QB = 900, 16, 4


# -- ops: packed state and row update -------------------------------------


def _codes(rng, n, m, lam=2, tables=2, divisions=2, nq=7, d=24):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = rng.normal(size=(nq, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m, lam, tables,
                                         divisions, 3)
    codes, _ = coding.encode_numpy(base, bank)
    qcodes, _ = coding.encode_numpy(queries, bank)
    return codes, ths.unpack_bits_numpy(qcodes, bank.code_bits), \
        bank.code_bits


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_fields(a, b, fields=FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=f)


@pytest.mark.parametrize("m,words", [(10, 1), (40, 3), (64, 4)])
def test_packed_state_and_scan_match_jax(rng, m, words):
    """Words, popcounts and the packed chunked scan (ragged tail that
    re-reads overlap rows, tombstones, adaptive budget) equal JAX's, and
    equal the port's unpacked flat scan."""
    n = 700
    codes, qbits, cb = _codes(rng, n, m)
    assert codes.shape[2] == words
    tomb = np.zeros(n, bool)
    tomb[rng.integers(0, n, 30)] = True
    packed = ths.build_scan_state_packed(codes, cb, chunk=128)
    jpacked = jhs.build_scan_state_packed(codes, cb)
    assert packed.words.dtype == torch.int32
    np.testing.assert_array_equal(packed.words.numpy().view(np.uint32),
                                  codes)
    np.testing.assert_array_equal(packed.popc.numpy(),
                                  np.asarray(jpacked.popc))
    kw = dict(anchor=10, margin=6)
    for chunk in (256, 1024):          # 3 chunks + tail; n <= chunk
        got = ths.scan_chunked(packed, torch.from_numpy(qbits),
                               torch.from_numpy(tomb), 60, chunk=chunk,
                               code_bits=cb, **kw)
        want = jhs.scan_chunked(jpacked, jnp.asarray(qbits),
                                jnp.asarray(tomb), 60, chunk=chunk,
                                approx=False, code_bits=cb, **kw)
        _assert_fields(got, want)
        flat = ths.scan(ths.build_scan_state(codes, cb),
                        torch.from_numpy(qbits), torch.from_numpy(tomb), 60,
                        **kw)
        _assert_fields(got, flat)


def test_packed_scan_requires_code_bits(rng):
    codes, _, cb = _codes(rng, 64, 10)
    packed = ths.build_scan_state_packed(codes, cb)
    with pytest.raises(ValueError, match="code_bits"):
        ths.scan_chunked(packed, torch.zeros((2, 40), dtype=torch.int8),
                         torch.zeros(64, dtype=torch.bool), 10)


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_update_rows_matches_jax(rng, layout):
    """An in-place fill of zero padding keeps the tensor's storage and
    shape and equals JAX's donated ``dynamic_update_slice``; the scan over
    it equals a fresh build of the same rows."""
    n, cut = 500, 420
    codes, qbits, cb = _codes(rng, n, 40)
    padded = np.concatenate([codes[:cut], np.zeros_like(codes[cut:])])
    if layout == "packed":
        st = ths.build_scan_state_packed(padded, cb)
        jst = jhs.build_scan_state_packed(padded, cb)
        buf, jbuf = st.words, jst.words
        new, jnew = coding.words_to_torch(codes[cut:]), jnp.asarray(
            codes[cut:])
    else:
        st = ths.build_scan_state(padded, cb)
        jst = jhs.build_scan_state(padded, cb)
        buf, jbuf = st.bits, jst.bits
        bits = ths.unpack_bits_numpy(codes[cut:], cb)
        new, jnew = torch.from_numpy(bits), jnp.asarray(bits)
    new_popc = ths.unpack_bits_numpy(codes[cut:], cb).sum(axis=1,
                                                          dtype=np.int32)
    ptr, shape = buf.data_ptr(), buf.shape
    out = ths.update_rows(buf, new, cut)
    popc = ths.update_rows(st.popc, torch.from_numpy(new_popc), cut)
    assert out is buf and out.data_ptr() == ptr and out.shape == shape
    jout = jhs.update_rows(jbuf, jnew, np.int64(cut))
    jpopc = jhs.update_rows(jst.popc, jnp.asarray(new_popc), np.int64(cut))
    got = out.numpy().view(np.uint32) if layout == "packed" else out.numpy()
    np.testing.assert_array_equal(got, np.asarray(jout))
    np.testing.assert_array_equal(popc.numpy(), np.asarray(jpopc))
    tomb = torch.zeros(n, dtype=torch.bool)
    q = torch.from_numpy(qbits)
    if layout == "packed":
        a = ths.scan_chunked(ths.PackedScanState(out, popc), q, tomb, 50,
                             chunk=128, code_bits=cb)
        b = ths.scan_chunked(ths.build_scan_state_packed(codes, cb), q, tomb,
                             50, chunk=128, code_bits=cb)
    else:
        a = ths.scan(ths.ScanState(out, popc), q, tomb, 50)
        b = ths.scan(ths.build_scan_state(codes, cb), q, tomb, 50)
    _assert_fields(a, b)


# -- the facade in both packages ------------------------------------------


def _cfg(c, **rt):
    kw = dict(refinement_limit=400, max_global_candidates=400, block_size=32,
              routing_mode="scan", rerank_limit=100, encode_backend="cpu",
              scan_native="off")
    kw.update(rt)
    return c.SystemConfig(
        paper=c.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=c.RuntimeConfig(**kw),
        eval=c.EvalConfig(k_variants=(1, 10))).validate()


def _carried(bank):
    return bank_from_jax(np.asarray(bank.alpha), np.asarray(bank.r),
                         np.asarray(bank.omega), bank.m, bank.lam,
                         bank.tables, bank.divisions, bank.seed)


def _pair(tmp_path, base, tag, **rt):
    """The JAX system and the port's, built from ``base`` with one bank."""
    js = JaxSystem(_cfg(jconfig, **rt), str(tmp_path / f"{tag}_jax"), D,
                   query_batch=QB)
    js.index_stream(base, batch_size=300)
    js.finalize_for_search()
    ts = ForwardSecureANNSystem(_cfg(tconfig, **rt),
                                str(tmp_path / f"{tag}_torch"), D,
                                query_batch=QB, device="cpu")
    ts.index.set_bank(_carried(js.index.bank))
    ts.index_stream(base, batch_size=300)
    ts.finalize_for_search()
    return js, ts


def _restore_pair(tmp_path, tag, **rt):
    js = JaxSystem(_cfg(jconfig, **rt), str(tmp_path / f"{tag}_jax"), D,
                   query_batch=QB)
    ts = ForwardSecureANNSystem(_cfg(tconfig, **rt),
                                str(tmp_path / f"{tag}_torch"), D,
                                query_batch=QB, device="cpu")
    nj, nt = js.restore_index_from_disk(), ts.restore_index_from_disk()
    assert nj == nt
    return js, ts


def _served(s, queries, k):
    return s.query_service.search_batches(
        [s.tokens.create_batch(queries[i:i + QB], k)
         for i in range(0, len(queries), QB)])


def _same(js, ts, queries, k=10):
    """Both systems serve ``queries`` with the same ids, distances (rtol
    1e-6) and decrypted counts; returns the port's ids."""
    ids = []
    for a, b in zip(_served(js, queries, k), _served(ts, queries, k)):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-6)
        assert [s.cand_decrypted for s in b.stats] == \
            [s.cand_decrypted for s in a.stats]
        ids.append(b.ids)
    return np.concatenate(ids)


def _rows(st):
    return st.words if isinstance(st, ths.PackedScanState) else st.bits


def _base(rng, n=N):
    return rng.normal(size=(n, D)).astype(np.float32) * 3


def _new(rng, k):
    return rng.normal(size=(k, D)).astype(np.float32) * 3 + 40.0


@pytest.mark.parametrize("packed", ["off", "on"])
def test_capacity_padding_matches_exact_fit(tmp_path, rng, packed):
    """A capacity-padded state serves like the exact-fit state, and like
    the JAX system with the same padding."""
    base = _base(rng)
    js, ts = _pair(tmp_path, base, "pad", scan_packed=packed,
                   scan_capacity_rows=N + 256)
    fit = ForwardSecureANNSystem(_cfg(tconfig, scan_packed=packed),
                                 str(tmp_path / "fit"), D, query_batch=QB,
                                 device="cpu")
    try:
        fit.index.set_bank(ts.index.bank)
        fit.index_stream(base, batch_size=300)
        fit.finalize_for_search()
        assert _rows(ts.index._scan_state).shape[0] == N + 256
        assert ts.index._scan_rows == js.index._scan_rows == N + 256
        assert isinstance(ts.index._scan_state, ths.PackedScanState) == \
            (packed == "on")
        ids = _same(js, ts, base[:6])
        assert np.array_equal(ids, _same(js, fit, base[:6]))
    finally:
        for s in (js, ts, fit):
            s.shutdown()


@pytest.mark.parametrize("packed", ["off", "on"])
def test_live_insert_fills_padding_in_place(tmp_path, rng, packed):
    """Inserts within capacity keep the state's storage and shape; the new
    rows are searchable at once and deletable, as in JAX."""
    base = _base(rng)
    js, ts = _pair(tmp_path, base, "ip", scan_packed=packed,
                   scan_capacity_rows=N + 64)
    try:
        rows = _rows(ts.index._scan_state)
        ptr, shape = rows.data_ptr(), rows.shape
        new = _new(rng, 8)
        new_ids = np.arange(N, N + 8)
        for s in (js, ts):
            s.insert_live(new_ids, new)
        rows = _rows(ts.index._scan_state)
        assert rows.data_ptr() == ptr and rows.shape == shape
        assert ts.index._n_rows == N + 8
        ids = _same(js, ts, new, k=3)
        np.testing.assert_array_equal(ids[:, 0], new_ids)
        assert _same(js, ts, base[7:8], k=1)[0, 0] == 7
        for s in (js, ts):
            s.delete(new_ids[:4])
        assert _same(js, ts, new[:1], k=3)[0, 0] != N
    finally:
        js.shutdown()
        ts.shutdown()


@pytest.mark.parametrize("packed", ["off", "on"])
def test_overflow_grows_geometrically(tmp_path, rng, packed):
    """Inserting past capacity reallocates once with headroom, as JAX
    does; later inserts fill the new padding in place."""
    base = _base(rng)
    js, ts = _pair(tmp_path, base, "ovf", scan_packed=packed,
                   scan_capacity_rows=N + 8)
    try:
        v = _new(rng, 24)
        ids = np.arange(N, N + 24)
        for s in (js, ts):
            s.insert_live(ids[:8], v[:8])      # fills the padding exactly
            s.insert_live(ids[8:16], v[8:16])  # overflow -> grow
        grown = ts.index._scan_rows
        assert grown == js.index._scan_rows >= N + 16 + 4096
        assert _rows(ts.index._scan_state).shape[0] == grown
        ptr = _rows(ts.index._scan_state).data_ptr()
        for s in (js, ts):
            s.insert_live(ids[16:], v[16:])    # fits the new padding
        assert ts.index._scan_rows == grown
        assert _rows(ts.index._scan_state).data_ptr() == ptr
        np.testing.assert_array_equal(_same(js, ts, v, k=1)[:, 0], ids)
        assert _same(js, ts, base[3:4], k=1)[0, 0] == 3
    finally:
        js.shutdown()
        ts.shutdown()


@pytest.mark.parametrize("packed", ["off", "on"])
def test_exact_fit_keeps_exact_growth(tmp_path, rng, packed):
    """scan_capacity_rows=0 (the default): appends grow the state to the
    exact new size."""
    base = _base(rng)
    js, ts = _pair(tmp_path, base, "exact", scan_packed=packed)
    try:
        v = _new(rng, 5)
        for s in (js, ts):
            s.insert_live(np.arange(N, N + 5), v)
        assert ts.index._scan_rows == js.index._scan_rows == N + 5
        assert _rows(ts.index._scan_state).shape[0] == N + 5
        np.testing.assert_array_equal(_same(js, ts, v, k=1)[:, 0],
                                      np.arange(N, N + 5))
    finally:
        js.shutdown()
        ts.shutdown()


@pytest.mark.parametrize("packed", ["off", "on"])
def test_capacity_restore_roundtrip(tmp_path, rng, packed):
    """Fast restore of a capacity-padded build with live inserts serves
    the same results (the checkpoint holds the real rows; the padding is
    applied again)."""
    base = _base(rng)
    js, ts = _pair(tmp_path, base, "rt", scan_packed=packed,
                   scan_capacity_rows=1200)
    v = _new(rng, 4)
    for s in (js, ts):
        s.insert_live(np.arange(N, N + 4), v)
        s.flush_all()
    before = _same(js, ts, v[:1])
    js.shutdown()
    ts.shutdown()
    js, ts = _restore_pair(tmp_path, "rt", scan_packed=packed,
                           scan_capacity_rows=1200)
    try:
        assert ts.index._scan_rows == 1200
        np.testing.assert_array_equal(_same(js, ts, v[:1]), before)
    finally:
        js.shutdown()
        ts.shutdown()


def test_live_insert_after_finalize(tmp_path, rng):
    """insert_live with the default scan_native ("auto": the native host
    kernel on the CPU, in both packages): appended points are searchable at
    once, survive fast restore, and a probe-mode restore of the stale
    checkpoint falls back to the rebuild, routing like JAX's."""
    n = 1200
    base = _base(rng, n)
    js, ts = _pair(tmp_path, base, "live", scan_native="auto")
    new = _new(rng, 5)
    new_ids = np.arange(n, n + 5)
    try:
        assert ts.index._scan_state is None          # native serving
        for s in (js, ts):
            s.insert_live(new_ids, new)
        ids = _same(js, ts, new, k=3)
        np.testing.assert_array_equal(ids[:, 0], new_ids)
        assert ts.search(ts.create_token(new[0], 3))[0].distance < 0.5
        assert _same(js, ts, base[7:8], k=1)[0, 0] == 7
        with pytest.raises(ValueError):
            ts.insert_live(np.array([n]), new[:1])
        for s in (js, ts):
            s.flush_all()
        before = _same(js, ts, new[:1])
    finally:
        js.shutdown()
        ts.shutdown()

    js, ts = _restore_pair(tmp_path, "live", scan_native="auto")
    try:
        assert ts.index.size == n + 5 and ts.index._table_stale
        np.testing.assert_array_equal(_same(js, ts, new[:1]), before)
    finally:
        js.shutdown()
        ts.shutdown()

    js, ts = _restore_pair(tmp_path, "live", routing_mode="probe")
    try:
        assert not ts.index._table_stale and not js.index._table_stale
        assert _same(js, ts, new[:1], k=3)[0, 0] == n
    finally:
        js.shutdown()
        ts.shutdown()


def test_append_rows_validates_first(tmp_path, rng):
    """append_rows refuses before finalize, outside scan mode, and bad
    input, and changes nothing when it refuses."""
    from fspann_tpu_torch.index.service import PartitionedIndex

    base = _base(rng)
    idx = PartitionedIndex(_cfg(tconfig), D, device="cpu")
    with pytest.raises(RuntimeError, match="post-finalize"):
        idx.append_rows(np.arange(2), base[:2])
    idx.stage(np.arange(N), base)
    idx.finalize()
    bad = [(np.arange(N, N + 2), base[:2, :4], ValueError),
           (np.array([-1, N]), base[:2], ValueError),
           (np.array([3, N]), base[:2], ValueError),
           (np.arange(N, N + 2), np.full((2, D), np.nan, np.float32),
            ValueError)]
    for ids, vecs, err in bad:
        with pytest.raises(err):
            idx.append_rows(ids, vecs)
    assert idx._n_rows == N and not idx._table_stale
    probe = PartitionedIndex(_cfg(tconfig, routing_mode="probe"), D,
                             device="cpu")
    probe.stage(np.arange(N), base)
    probe.finalize()
    with pytest.raises(RuntimeError, match="routing_mode='scan'"):
        probe.append_rows(np.arange(N, N + 2), base[:2])


def test_scan_system_delete_and_undelete(tmp_path, rng):
    """delete/undelete visibility flows through the scan's tombstones
    (default scan_native: the native host kernel on the CPU)."""
    base = _base(rng)
    js, ts = _pair(tmp_path, base, "del", scan_native="auto",
                   refinement_limit=300, max_global_candidates=300,
                   rerank_limit=80)
    try:
        assert _same(js, ts, base[42:43], k=1)[0, 0] == 42
        for s in (js, ts):
            s.delete([42])
        assert _same(js, ts, base[42:43], k=1)[0, 0] != 42
        for s in (js, ts):
            assert s.undelete([42]) == [42]
        assert _same(js, ts, base[42:43], k=1)[0, 0] == 42
    finally:
        js.shutdown()
        ts.shutdown()


def test_packed_system_end_to_end(tmp_path, rng):
    """scan_packed='on' at the system level: identical results to 'off'
    and to JAX; live insert appends packed words; restore keeps the packed
    layout and the results."""
    n, q = 3000, 6
    base = rng.normal(size=(n, D)).astype(np.float32) * 4
    queries = base[rng.integers(0, n, q)] + \
        rng.normal(size=(q, D)).astype(np.float32) * 0.05
    js, ts = _pair(tmp_path, base, "on", scan_packed="on")
    off = ForwardSecureANNSystem(_cfg(tconfig), str(tmp_path / "off"), D,
                                 query_batch=QB, device="cpu")
    try:
        off.index.set_bank(ts.index.bank)
        off.index_stream(base, batch_size=1500)
        off.finalize_for_search()
        assert isinstance(ts.index._scan_state, ths.PackedScanState)
        assert isinstance(off.index._scan_state, ths.ScanState)
        assert np.array_equal(_same(js, ts, queries),
                              _same(js, off, queries))
        new = rng.normal(size=(5, D)).astype(np.float32) * 4
        new_ids = np.arange(n, n + 5, dtype=np.int64)
        for s in (js, ts, off):
            s.insert_live(new_ids, new)
        qn = new[2:3] + 0.01
        a = _same(js, ts, qn, k=5)
        assert np.array_equal(a, _same(js, off, qn, k=5))
        assert new_ids[2] in a
        r_on = _same(js, ts, queries)
        ts.flush_all()
    finally:
        for s in (js, ts, off):
            s.shutdown()
    back = ForwardSecureANNSystem(_cfg(tconfig, scan_packed="on"),
                                  str(tmp_path / "on_torch"), D,
                                  query_batch=QB, device="cpu")
    try:
        assert back.restore_index_from_disk() == n + 5
        assert isinstance(back.index._scan_state, ths.PackedScanState)
        ids = np.concatenate([r.ids for r in _served(back, queries, 10)])
        np.testing.assert_array_equal(ids, r_on)
    finally:
        back.shutdown()


LAYOUTS = {"unpacked": {}, "packed": {"scan_packed": "on"},
           "native": {"scan_native": "on"}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_lifecycle_steps_match_jax(tmp_path, rng, layout):
    """build → serve → insert in place → insert past capacity → delete →
    rotate and re-encrypt → flush_all → restore: after every step the
    port serves what JAX serves."""
    rt = dict(scan_capacity_rows=N + 64, **LAYOUTS[layout])
    base = _base(rng)
    probe = np.concatenate([base[:6] + 0.01, _new(rng, 2)])
    js, ts = _pair(tmp_path, base, "steps", **rt)
    new = _new(rng, 100)
    new_ids = np.arange(N, N + 100)
    try:
        assert (ts.index._scan_state is None) == (layout == "native")
        _same(js, ts, probe)
        for s in (js, ts):
            s.insert_live(new_ids[:40], new[:40])          # in place
        assert ts.index._scan_rows == js.index._scan_rows
        _same(js, ts, np.concatenate([probe, new[:40:7]]))
        for s in (js, ts):
            s.insert_live(new_ids[40:], new[40:])          # past capacity
        assert ts.index._scan_rows == js.index._scan_rows
        _same(js, ts, np.concatenate([probe, new[::9]]))
        for s in (js, ts):
            s.delete([2, 5, N + 3, N + 50])
        everything = np.concatenate([probe, new[::9], base[[2, 5]]])
        ids = _same(js, ts, everything)
        assert not np.isin(ids, [2, 5, N + 3, N + 50]).any()
        reps = [s.run_selective_reencryption() for s in (js, ts)]
        assert reps[1]["reencrypted"] == reps[0]["reencrypted"] > 0
        assert reps[1]["new_version"] == reps[0]["new_version"] == 2
        after = _same(js, ts, everything)
        np.testing.assert_array_equal(after, ids)
        for s in (js, ts):
            s.flush_all()
    finally:
        js.shutdown()
        ts.shutdown()
    js, ts = _restore_pair(tmp_path, "steps", **rt)
    try:
        assert ts.index.size == N + 100 - 4
        np.testing.assert_array_equal(_same(js, ts, everything), after)
    finally:
        js.shutdown()
        ts.shutdown()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_table_after_live_inserts_restores_in_port(tmp_path, rng,
                                                       layout):
    """A JAX scan table.npz written after live inserts (stale table, the
    appended rows in point_codes) loads through the port's load_table and
    routes like the JAX index."""
    from fspann_tpu_torch.index.service import PartitionedIndex

    base = _base(rng)
    js = JaxSystem(_cfg(jconfig), str(tmp_path / "jax"), D, query_batch=QB)
    try:
        js.index_stream(base, batch_size=300)
        js.finalize_for_search()
        js.insert_live(np.arange(N, N + 5), _new(rng, 5))
        js.delete([4, N + 1])
        js.flush_all()
        path = str(tmp_path / "jax" / "table.npz")
        with np.load(path) as z:
            assert bool(z["table_stale"]) and len(z["point_codes"]) == N + 5
        idx = PartitionedIndex(_cfg(tconfig, **LAYOUTS[layout]), D,
                               device="cpu")
        idx.set_bank(_carried(js.index.bank))
        assert idx.load_table(path, expect_rows=N + 5)
        assert idx._table_stale
        idx.mark_deleted([4, N + 1])
        q = np.concatenate([base[:5] + 0.01, _new(rng, 3)])
        jq = js.index.encode_queries(q)
        _assert_fields(idx.route_batch(*(np.asarray(a) for a in jq)),
                       js.index.route_batch(*jq))
    finally:
        js.shutdown()


# -- the facade lifecycle on the port (tests/test_lifecycle.py) -------------

DIM = 12


def _lcfg():
    return tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=6, lam=2, divisions=2, tables=2, seed=5),
        runtime=tconfig.RuntimeConfig(refinement_limit=300,
                                      max_global_candidates=300,
                                      block_size=32),
        eval=tconfig.EvalConfig(k_variants=(1, 5))).validate()


def test_buffered_inserter_flush_threshold():
    from fspann_tpu_torch.store.write_buffer import BufferedInserter

    got = []
    buf = BufferedInserter(lambda i, v: got.append((i.copy(), v.copy())),
                           dim=3, flush_threshold=4)
    for i in range(10):
        buf.add(i, np.full(3, i, np.float32))
    assert len(got) == 2 and len(buf) == 2
    buf.flush()
    assert len(got) == 3
    np.testing.assert_array_equal(
        np.sort(np.concatenate([g[0] for g in got])), np.arange(10))
    with pytest.raises(ValueError):
        buf.add(11, np.zeros(4, np.float32))


def test_single_insert_path_via_buffer(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    try:
        vecs = rng.normal(size=(1200, DIM)).astype(np.float32)
        for i, v in enumerate(vecs):
            sys_.insert(i, v)
        sys_.finalize_for_search()   # flushes the buffer
        assert sys_.index.size == 1200
        assert sys_.search(sys_.create_token(vecs[7], 1))[0].id == 7
    finally:
        sys_.shutdown()


def test_coordinator_csv_and_counters(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        sys_.search(sys_.create_token(
            rng.normal(size=DIM).astype(np.float32), 5))
        assert sys_.run_selective_reencryption()["reencrypted"] > 0
        csv_path = str(tmp_path / "db" / "reencrypt_metrics.csv")
        lines = open(csv_path).read().strip().splitlines()
        assert len(lines) == 2 and lines[0].startswith("timestamp")
        assert sys_.metrics.counters["reenc.passes"] == 1
        sys_.search(sys_.create_token(
            rng.normal(size=DIM).astype(np.float32), 5))
        sys_.run_selective_reencryption()
        assert len(open(csv_path).read().strip().splitlines()) == 3
    finally:
        sys_.shutdown()


def test_query_cache_hit(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        q = rng.normal(size=DIM).astype(np.float32)
        r1 = sys_.search(sys_.create_token(q, 5))
        r2 = sys_.search(sys_.create_token(q, 5))
        assert [x.id for x in r1] == [x.id for x in r2]
        assert sys_.metrics.counters.get("query.cache_hits", 0) == 1
    finally:
        sys_.shutdown()


def test_key_retention_enforcement(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        for _ in range(4):
            sys_.rotation.force_rotate_now()
            sys_.store.reencrypt_all()
        dropped = sys_.rotation.finalize_rotation()
        assert dropped == [1, 2, 3]
        _out, ok = sys_.store.load_decrypt_batch(np.arange(1100))
        assert ok.all()
        for v in dropped:
            assert not os.path.exists(sys_.store._arena_path(v))
    finally:
        sys_.shutdown()


def test_empty_index_finalize_raises(tmp_path):
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    try:
        with pytest.raises(RuntimeError, match="nothing staged"):
            sys_.finalize_for_search()
    finally:
        sys_.shutdown()


def test_stage_after_finalize_raises(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        with pytest.raises(RuntimeError, match="finalized"):
            sys_.batch_insert(np.array([99999]),
                              rng.normal(size=(1, DIM)).astype(np.float32))
    finally:
        sys_.shutdown()


def test_compact_storage_and_undelete_window(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        sys_.rotation.force_rotate_now()
        sys_.store.reencrypt_ids(np.arange(500))
        sys_.delete([7])
        before = sys_.store.size_bytes()
        assert sys_.compact_storage()["bytes_freed"] > 0
        assert sys_.store.size_bytes() < before
        _out, ok = sys_.store.load_decrypt_batch(np.arange(1100))
        assert ok.sum() == 1099 and not ok[7]
        sys_.undelete([7])
        _out2, ok2 = sys_.store.load_decrypt_batch(np.array([7]))
        assert not ok2[0]
    finally:
        sys_.shutdown()


def test_immediate_reencryption_mode(tmp_path, rng):
    imm = dataclasses.replace(
        _lcfg(), reencryption=tconfig.ReencryptionConfig(mode="immediate"))
    sys_ = ForwardSecureANNSystem(imm, str(tmp_path / "db"), DIM, device="cpu")
    try:
        vecs = rng.normal(size=(1100, DIM)).astype(np.float32)
        sys_.index_stream(vecs, batch_size=600)
        sys_.finalize_for_search()
        q = vecs[17]
        before = [(r.id, round(r.distance, 5))
                  for r in sys_.search(sys_.create_token(q, 5))]
        sys_.rotation.force_rotate_now()
        sys_._cache_gen += 1
        after = [(r.id, round(r.distance, 5))
                 for r in sys_.search(sys_.create_token(q, 5))]
        assert after == before
        assert sys_.tracker.unique_count() == 0
        touched = sys_.query_service.last_stats[0].cand_decrypted
        assert touched > 0
        assert sys_.store.meta.count_with_version(2) >= touched
    finally:
        sys_.shutdown()


def test_immediate_reencryption_covers_live_inserts(tmp_path, rng):
    """reenc.mode=immediate on the scan route: a live-inserted point that a
    query touches is migrated to the current key with the rest."""
    cfg = dataclasses.replace(
        _cfg(tconfig), reencryption=tconfig.ReencryptionConfig(
            mode="immediate"))
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "db"), D, device="cpu")
    try:
        sys_.index_stream(_base(rng), batch_size=300)
        sys_.finalize_for_search()
        new = _new(rng, 3)
        sys_.insert_live(np.arange(N, N + 3), new)
        sys_.rotation.force_rotate_now()
        assert sys_.search(sys_.create_token(new[1], 3))[0].id == N + 1
        assert sys_.store.key_version_of(N + 1) == 2
    finally:
        sys_.shutdown()


def test_restore_at_explicit_older_version(tmp_path, rng):
    vecs = rng.normal(size=(1100, DIM)).astype(np.float32)
    sys_ = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                  device="cpu")
    sys_.index_stream(vecs, batch_size=600)
    sys_.finalize_for_search()
    sys_.rotation.force_rotate_now()   # v2
    sys_.rotation.force_rotate_now()   # v3
    sys_.store.meta.save_index_version(3)
    sys_.shutdown()
    r = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                               device="cpu")
    try:
        assert r.restore_index_from_disk(version=2) == 1100
        assert r.rotation.pinned_version == 2
        assert r.search(r.create_token(vecs[9], 5))[0].id == 9
    finally:
        r.shutdown()
    r2 = ForwardSecureANNSystem(_lcfg(), str(tmp_path / "db"), DIM,
                                device="cpu")
    try:
        with pytest.raises(KeyError):
            r2.restore_index_from_disk(version=99)
    finally:
        r2.shutdown()


# -- forward-security games G1-G6 on the port --------------------------------


@pytest.fixture
def game(tmp_path, rng):
    from fspann_tpu_torch.crypto.keys import KeyManager
    from fspann_tpu_torch.crypto.rotation import KeyRotationService
    from fspann_tpu_torch.store.point_store import PointStore

    km = KeyManager(str(tmp_path / "ks.blob"))
    store = PointStore(str(tmp_path / "db"), km, dim=8)
    svc = KeyRotationService(km, store)
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    store.insert_batch(np.arange(50), vecs)
    yield km, store, svc, vecs
    store.close()


def _raw_record(store, pid):
    m = store.meta.get(pid)
    rid, rkv, _dim, iv, ct = store._reader(m.key_version).read_record(
        m.arena_off)
    assert rid == pid
    return rkv, iv, ct


def test_g1_old_key_fails_on_reencrypted(game):
    from fspann_tpu_torch.crypto import aesgcm
    from fspann_tpu_torch.types import aad_for

    km, store, svc, _ = game
    stolen = aesgcm.GcmKey(km.get_version(1).key)
    svc.force_rotate_now()
    store.reencrypt_ids(list(range(50)))
    decrypted = 0
    for pid in range(50):
        kv, iv, ct = _raw_record(store, pid)
        assert kv == 2
        for aad_v in (1, 2):
            try:
                stolen.open(iv, ct, aad_for(pid, aad_v, 8))
                decrypted += 1
            except ValueError:
                pass
    assert decrypted == 0


def test_g2_ciphertext_indistinguishable_across_rotation(game):
    _km, store, svc, vecs = game
    before = {pid: _raw_record(store, pid) for pid in range(50)}
    svc.force_rotate_now()
    store.reencrypt_ids(list(range(50)))
    for pid in range(50):
        _kv0, iv0, ct0 = before[pid]
        _kv1, iv1, ct1 = _raw_record(store, pid)
        assert iv0 != iv1 and ct0 != ct1
    out, ok = store.load_decrypt_batch(np.arange(50))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)


def test_g3_selective_touches_only_touched(game):
    from fspann_tpu_torch.crypto.rotation import ReencryptionTracker

    _km, store, svc, _ = game
    svc.force_rotate_now()
    tracker = ReencryptionTracker()
    tracker.record([17])
    assert svc.reencrypt_touched(tracker.drain()).reencrypted == 1
    assert store.key_version_of(17) == 2
    assert all(store.key_version_of(p) == 1 for p in range(50) if p != 17)


def test_g4_usage_accounting_exact(game):
    _km, store, svc, _ = game
    assert store.meta.count_with_version(1) == 50
    svc.force_rotate_now()
    store.reencrypt_ids([0, 1, 2])
    assert store.meta.count_with_version(1) == 47
    assert store.meta.count_with_version(2) == 3
    store.delete([0, 5])
    assert store.meta.count_with_version(2) == 2
    assert store.meta.count_with_version(1) == 46


def test_g5_safe_deletion_soundness(game):
    km, store, svc, vecs = game
    svc.force_rotate_now()
    assert not svc.is_safe_to_delete(1)
    assert svc.finalize_rotation() == []
    store.reencrypt_ids(list(range(50)))
    assert svc.is_safe_to_delete(1)
    svc.force_rotate_now()
    assert svc.finalize_rotation() == [1]
    with pytest.raises(KeyError):
        km.get_version(1)
    assert not os.path.exists(store._arena_path(1))
    out, ok = store.load_decrypt_batch(np.arange(50))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)


def test_g6_correctness_preserved_under_rotation(game):
    _km, store, svc, vecs = game
    for round_ in range(3):
        svc.force_rotate_now()
        store.reencrypt_ids(list(range(round_ * 10, round_ * 10 + 10)))
        out, ok = store.load_decrypt_batch(np.arange(50))
        assert ok.all()
        np.testing.assert_allclose(out, vecs, rtol=1e-6)


@pytest.mark.parametrize("backend", ["cpu", "default"])
def test_staged_bytes_and_host_bank_match_jax(rng, backend):
    """``PartitionedIndex.staged_bytes`` counts the same staging arrays as
    the JAX index's, batch by batch (nothing while rows wait for the bank's
    sample), and ``_host_bank`` holds the bank as float32 numpy arrays,
    made once, also when the bank was installed as tensors."""
    from fspann_tpu.index.service import PartitionedIndex as JIndex
    from fspann_tpu_torch.index.service import PartitionedIndex

    j = JIndex(_cfg(jconfig, encode_backend=backend), D)
    t = PartitionedIndex(_cfg(tconfig, encode_backend=backend), D,
                         device="cpu")
    vecs = rng.normal(size=(1600, D)).astype(np.float32)
    for s in range(0, 1600, 400):
        for idx in (j, t):
            idx.stage(np.arange(s, s + 400), vecs[s:s + 400])
        assert t.staged_bytes == j.staged_bytes
        assert (t.staged_bytes > 0) == (s + 400 >= 1000)
    hb = t._host_bank()
    assert t._host_bank() is hb
    for f in ("alpha", "r", "omega"):
        a = getattr(hb, f)
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_array_equal(a, getattr(t.bank, f))
    t.bank = coding.bank_to(t.bank, "cpu")           # installed as tensors
    t._bank_cpu = None
    np.testing.assert_array_equal(t._host_bank().alpha, hb.alpha)
