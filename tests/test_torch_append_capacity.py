"""The live insert's host arrays (``index/service.py``): ``append_rows``
writes only its new rows into buffers with spare rows, and regrows them
geometrically when the spare rows run out.  On the CPU at a small size, held
to the path it replaces, where every insert concatenated the whole code
array and row ids (a twin index with that path patched back in, built from
the same bank): the arrays, ``save_table``'s checkpoint and the routes,
after every call, across several regrowths, from a finalize and from a
restore, served by the native host scan and by the device scan state with
and without capacity padding; views taken earlier keep their rows; a refused
insert writes nothing; the counter ``index.append.host_grow_bytes``."""

import math

import numpy as np
import pytest
import torch

from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.index import service
from fspann_tpu_torch.index.service import PartitionedIndex
from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.utils import profiler

torch.set_num_threads(1)

N, D, K = 600, 16, 40
FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")
GROW = "index.append.host_grow_bytes"


def _cfg(**rt):
    kw = dict(refinement_limit=300, max_global_candidates=300, block_size=32,
              routing_mode="scan", rerank_limit=100, encode_backend="cpu",
              scan_native="off", scan_capacity_rows=0)
    kw.update(rt)
    return tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3,
                                  seed=13),
        runtime=tconfig.RuntimeConfig(**kw),
        eval=tconfig.EvalConfig(k_variants=(1, 10))).validate()


def _vecs(rng, n, shift=0.0):
    return rng.normal(size=(n, D)).astype(np.float32) * 3 + shift


def _index(base, start="finalize", bank=None, tmp_path=None, tag="a",
           **rt):
    """A frozen scan index over ``base``: finalized, or restored from the
    finalized index's ``table.npz`` into a fresh one."""
    idx = PartitionedIndex(_cfg(**rt), D, device="cpu")
    if bank is not None:
        idx.set_bank(bank)
    idx.stage(np.arange(len(base)), base)
    idx.finalize()
    if start == "finalize":
        return idx
    path = str(tmp_path / f"{tag}_table.npz")
    idx.save_table(path)
    back = PartitionedIndex(_cfg(**rt), D, device="cpu")
    back.set_bank(idx.bank)
    assert back.load_table(path, expect_rows=len(base))
    return back


def _concat_into(buf, view, new):
    """The replaced path: a whole new array on every insert."""
    return None, np.concatenate([view, new]), 0


def _old_append(idx, ids, vecs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(service, "_append_into", _concat_into)
        idx.append_rows(ids, vecs)


def _grown(fn, *args):
    before = profiler.totals()["counters"].get(GROW, 0)
    fn(*args)
    return profiler.totals()["counters"].get(GROW, 0) - before


def _route(idx, q):
    res = idx.route_batch(*idx.encode_queries(q))
    return [None if a is None else
            a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in (getattr(res, f) for f in FIELDS)]


def _row_bytes(idx):
    return idx._scan_codes[0].nbytes + idx._row_ids[0].nbytes


@pytest.mark.parametrize("capacity", [0, N + 100])
@pytest.mark.parametrize("native", ["on", "off"])
@pytest.mark.parametrize("start", ["finalize", "load_table"])
def test_appends_equal_the_concatenating_path(rng, tmp_path, monkeypatch,
                                              start, native, capacity):
    """Across several regrowths every call leaves the arrays, the
    checkpoint and the routes equal to the concatenating path's, and to
    the arrays rebuilt here; ids with gaps and a delete route through the
    row ids."""
    monkeypatch.setattr(service, "GROW_MIN_ROWS", 8)
    base = _vecs(rng, N)
    rt = dict(scan_native=native, scan_capacity_rows=capacity)
    idx = _index(base, start, tmp_path=tmp_path, tag="new", **rt)
    old = _index(base, start, bank=idx.bank, tmp_path=tmp_path, tag="old",
                 **rt)
    assert (idx._scan_state is None) == (native == "on")
    codes = coding.encode_numpy(base, idx._host_bank())[0]
    ids_all = np.arange(N, dtype=np.int64)
    np.testing.assert_array_equal(idx._scan_codes, codes)
    regrowths, nxt = 0, N
    for call in range(12):
        vecs = _vecs(rng, K, shift=20.0 + call)
        ids = nxt + 2 * np.arange(K, dtype=np.int64)   # gaps: not dense
        nxt = int(ids[-1]) + 3
        regrowths += _grown(idx.append_rows, ids, vecs) > 0
        _old_append(old, ids, vecs)
        codes = np.concatenate(
            [codes, coding.encode_numpy(vecs, idx._host_bank())[0]])
        ids_all = np.concatenate([ids_all, ids])
        if call == 5:
            for ix in (idx, old):
                ix.mark_deleted([int(ids[3]), 7])
        for got, want in ((idx._scan_codes, codes),
                          (idx._row_ids, ids_all)):
            assert got.flags.c_contiguous and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(old._scan_codes, codes)
        np.testing.assert_array_equal(old._row_ids, ids_all)
        assert not idx._dense and idx._n_rows == len(ids_all)
        idx.save_table(str(tmp_path / "new.npz"))
        old.save_table(str(tmp_path / "old.npz"))
        with np.load(tmp_path / "new.npz") as a, \
                np.load(tmp_path / "old.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
                assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a["point_codes"], codes)
            np.testing.assert_array_equal(a["row_ids"], ids_all)
        q = np.concatenate([vecs[:3], _vecs(rng, 3)])
        for f, x, y in zip(FIELDS, _route(idx, q), _route(old, q)):
            if x is None or y is None:
                assert x is None and y is None, f
            else:
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert idx.max_route_id() == old.max_route_id() == ids_all.max()
    assert regrowths >= 3


@pytest.mark.parametrize("start", ["finalize", "load_table"])
def test_first_insert_regrows_then_spare_rows_serve(rng, tmp_path, start):
    """Finalize and restore leave exact-size arrays: the first insert
    copies the prefix once into a buffer with an eighth (at least
    GROW_MIN_ROWS) spare, and the inserts that fit write only their
    rows."""
    base = _vecs(rng, N)
    idx = _index(base, start, tmp_path=tmp_path)
    assert idx._codes_buf is None and len(idx._scan_codes) == N
    first = _grown(idx.append_rows, np.arange(N, N + K), _vecs(rng, K))
    assert first == N * _row_bytes(idx)
    assert len(idx._codes_buf) == len(idx._ids_buf) == \
        N + K + service.GROW_MIN_ROWS
    buf, n = idx._codes_buf, N + K
    for _ in range(5):
        assert _grown(idx.append_rows, np.arange(n, n + K),
                      _vecs(rng, K)) == 0
        n += K
        assert idx._codes_buf is buf and idx._scan_codes.base is buf
        assert idx._row_ids.base is idx._ids_buf
    assert idx._dense and len(idx._scan_codes) == n


def test_restore_over_inserted_rows_regrows(rng, tmp_path):
    """A restore into an index that has inserted sets exact-size arrays
    again: the next insert regrows from them, and the rows the earlier
    inserts wrote, seen through a view taken before the restore, stay."""
    base = _vecs(rng, N)
    idx = _index(base)
    path = str(tmp_path / "table.npz")
    idx.save_table(path)
    idx.append_rows(np.arange(N, N + K), _vecs(rng, K))
    codes, want = idx._scan_codes, idx._scan_codes.copy()
    assert idx.load_table(path, expect_rows=N)
    vecs = _vecs(rng, K, shift=30.0)
    assert _grown(idx.append_rows, np.arange(N, N + K), vecs) == \
        N * _row_bytes(idx)
    np.testing.assert_array_equal(codes, want)
    np.testing.assert_array_equal(idx._scan_codes[:N], want[:N])
    np.testing.assert_array_equal(
        idx._scan_codes[N:], coding.encode_numpy(vecs, idx._host_bank())[0])


@pytest.mark.parametrize("moment", ["spare", "regrowth"])
def test_earlier_views_keep_their_rows(rng, monkeypatch, moment):
    """A view of the arrays taken before an insert into spare rows, or
    before a regrowth, reads the same rows after it and after later
    inserts; the insert into spare rows shares the view's memory."""
    monkeypatch.setattr(service, "GROW_MIN_ROWS", 8)
    idx = _index(_vecs(rng, N))
    idx.append_rows(np.arange(N, N + 8), _vecs(rng, 8))
    n = N + 8
    if moment == "regrowth":
        spare = len(idx._codes_buf) - n
        idx.append_rows(np.arange(n, n + spare - 2), _vecs(rng, spare - 2))
        n += spare - 2
    codes, ids = idx._scan_codes, idx._row_ids
    want_codes, want_ids = codes.copy(), ids.copy()
    buf = idx._codes_buf
    idx.append_rows(np.arange(n, n + 4), _vecs(rng, 4, shift=9.0))
    assert (idx._codes_buf is buf) == (moment == "spare")
    assert np.shares_memory(idx._scan_codes, codes) == (moment == "spare")
    for _ in range(3):
        np.testing.assert_array_equal(codes, want_codes)
        np.testing.assert_array_equal(ids, want_ids)
        n = idx._n_rows
        idx.append_rows(np.arange(n, n + 30), _vecs(rng, 30, shift=-9.0))
    np.testing.assert_array_equal(idx._scan_codes[:len(want_codes)],
                                  want_codes)
    np.testing.assert_array_equal(idx._row_ids[:len(want_ids)], want_ids)


BAD = {"width": lambda n, v: (np.arange(n, n + 2), v[:2, :4]),
       "length": lambda n, v: (np.arange(n, n + 3), v[:2]),
       "negative": lambda n, v: (np.array([-1, n]), v[:2]),
       "collision": lambda n, v: (np.array([n + 1, 3]), v[:2]),
       "nan": lambda n, v: (np.arange(n, n + 2),
                            np.full((2, D), np.nan, np.float32))}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_refused_insert_writes_nothing(rng, bad):
    """A refused insert raises before any write: the arrays, the buffers'
    spare rows and the counter stay as they were, and the next good insert
    holds exactly its own rows after the old ones."""
    idx = _index(_vecs(rng, N))
    idx.append_rows(np.arange(N, N + K), _vecs(rng, K))
    n = N + K
    codes, ids = idx._scan_codes, idx._row_ids
    bufs = (idx._codes_buf.copy(), idx._ids_buf.copy())
    before = profiler.totals()["counters"].get(GROW, 0)
    with pytest.raises(ValueError):
        idx.append_rows(*BAD[bad](n, _vecs(rng, 3)))
    assert profiler.totals()["counters"].get(GROW, 0) == before
    assert idx._scan_codes is codes and idx._row_ids is ids
    assert idx._n_rows == n
    np.testing.assert_array_equal(idx._codes_buf, bufs[0])
    np.testing.assert_array_equal(idx._ids_buf, bufs[1])
    vecs = _vecs(rng, 5)
    idx.append_rows(np.arange(n, n + 5), vecs)
    np.testing.assert_array_equal(idx._row_ids,
                                  np.arange(n + 5, dtype=np.int64))
    np.testing.assert_array_equal(
        idx._scan_codes[n:], coding.encode_numpy(vecs, idx._host_bank())[0])
    np.testing.assert_array_equal(idx._scan_codes[:n], codes)


@pytest.mark.parametrize("rows", [1, 8, 50])
def test_regrowths_are_logarithmic_and_counted(rng, monkeypatch, rows):
    """Over K inserts the arrays regrow O(log K) times: each regrowth
    counts the prefix it copies (codes and ids), every other call counts
    0, and the counter's total is their sum."""
    monkeypatch.setattr(service, "GROW_MIN_ROWS", 8)
    idx = _index(_vecs(rng, N))
    calls = 400 // rows + 20
    start = profiler.totals()["counters"].get(GROW, 0)
    total, regrowths = 0, 0
    for _ in range(calls):
        n, buf = idx._n_rows, idx._codes_buf
        got = _grown(idx.append_rows, np.arange(n, n + rows),
                     _vecs(rng, rows))
        if idx._codes_buf is buf:
            assert got == 0
        else:
            assert got == n * _row_bytes(idx)
            regrowths += 1
        total += got
    assert 2 <= regrowths <= 2 + math.log(idx._n_rows / N) / math.log(9 / 8)
    assert profiler.totals()["counters"][GROW] - start == total
    # an insert's root records the counter, 0 where nothing regrew
    n = idx._n_rows
    with profiler.span("system.insert_live"):
        idx.append_rows(np.arange(n, n + 1), _vecs(rng, 1))
    assert profiler.recent("system.insert_live", 1)[0][GROW] == 0
