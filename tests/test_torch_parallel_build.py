"""The set-up on every host core: ``coding.encode_numpy`` hands the chunks
of a call of more than one chunk to a pool of ``width`` host threads, and
``partition.build_partitions_numpy`` sorts its groups on one, over
group-major copies or over strided views of the point-major arrays.  On the
CPU, against the one-thread path and the JAX package's functions, bit for
bit, across chunk edges and at several widths; a pool of more threads than
cores under a short switch interval; the queries' and the live inserts'
encodes on the caller's thread; the width the configuration's
``setup_threads`` gives the set-up; and the set-up's spans and counters under
their roots (``system.index_stream``: ``index.encode``, ``store.seal``,
``index.encode.calls`` and ``index.encode.workers``; ``system.finalize``:
``index.finalize.tables``)."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import partition as jpartition
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.ops import coding, partition
from fspann_tpu_torch.utils import profiler, threads

torch.set_num_threads(1)

CHUNK = 4096
SIZES = [1, CHUNK, CHUNK + 1, 3 * CHUNK + 5]
WIDTHS = [1, 2, 3, 8]
D = 24


@pytest.fixture(scope="module")
def banks():
    """(JAX bank, the port's copy of it): m 64, λ 2, 2 tables x 3 divisions,
    so 4 words a group."""
    rng = np.random.default_rng(20)
    sample = rng.normal(size=(1000, D)).astype(np.float32) * 3
    jb = jcoding.build_bank_from_sample(sample, 64, 2, 2, 3, 7)
    return jb, bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                             np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                             jb.divisions, jb.seed)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(21)
    return rng.normal(size=(max(SIZES), D)).astype(np.float32) * 3


def _counters():
    c = profiler.totals()["counters"]
    return c.get("index.encode.calls", 0), c.get("index.encode.workers", 0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("width", WIDTHS)
def test_encode_numpy_equals_one_thread_and_jax(monkeypatch, banks, rows, n,
                                                width):
    jb, bank = banks
    x = rows[:n]
    one = coding.encode_numpy(x, bank)
    calls, workers = _counters()
    got = coding.encode_numpy(x, bank, width=width)
    calls2, workers2 = _counters()
    ref = jcoding.encode_numpy(x, jb)
    for a, b, c in zip(got, one, ref):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # a call of more than one chunk counts itself and the threads that
    # took its rows: one where the pool is one thread wide
    chunks = -(-n // CHUNK)
    most = min(chunks, width)
    assert calls2 - calls == (chunks > 1)
    if chunks == 1:
        assert workers2 == workers
    else:
        assert 1 <= workers2 - workers <= most
        if most == 1:
            assert workers2 - workers == 1


def test_more_workers_than_cores_lose_no_chunk(monkeypatch, banks):
    """32 workers on 41 chunks with a switch interval of 1 µs: every chunk
    is written once, where it belongs."""
    jb, bank = banks
    x = np.random.default_rng(22).normal(size=(40 * 1024 + 7, D)).astype(
        np.float32)
    one = coding.encode_numpy(x, bank, chunk=1024)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got = coding.encode_numpy(x, bank, chunk=1024, width=32)
            np.testing.assert_array_equal(got[0], one[0])
            np.testing.assert_array_equal(got[1], one[1])
    finally:
        sys.setswitchinterval(old)


def test_the_pool_runs_numpy_blas_on_one_thread(monkeypatch, banks):
    """While a pooled encode runs, numpy's OpenBLAS is on one thread, and
    after it at its count from before, also when two pooled encodes run
    at once."""
    fns = coding._numpy_blas_threads()
    assert (fns is not None) == ("openblas" in np.__config__.CONFIG[
        "Build Dependencies"]["blas"]["name"])
    if fns is None:
        return
    get, _ = fns
    before = get()
    jb, bank = banks
    x = np.random.default_rng(26).normal(size=(4 * 1024, D)).astype(
        np.float32)
    seen = []

    def map_threads(*a, **kw):
        seen.append(get())
        return real(*a, **kw)

    real = threads.map_threads
    monkeypatch.setattr(threads, "map_threads", map_threads)
    callers = [threading.Thread(target=coding.encode_numpy, args=(x, bank),
                                kwargs={"chunk": 1024, "width": 4})
               for _ in range(2)]
    for t in callers:
        t.start()
    for t in callers:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in callers)
    assert seen == [1, 1]
    assert get() == before


def _keys_codes(seed, g, n, words):
    """Keys with many ties (ties break by id) and packed codes, by the JAX
    package's packer; ``words`` 4 so that the wide key has bits to read."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-3, 4, size=(n, g, 64)).astype(np.int32)
    h[n // 2:] = h[:n - n // 2]
    codes = np.asarray(jcoding.pack_codes(jnp.asarray(h), 64, 2))
    assert codes.shape[-1] == words
    keys = np.array(jcoding.keys_from_codes(jnp.asarray(codes)))
    # most keys of a group equal: the order is decided by key2 and the ids
    keys[: n // 3] = keys[0]
    return (np.ascontiguousarray(keys.T),
            np.ascontiguousarray(np.transpose(codes, (1, 0, 2))))


@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("width", [1, 2, 5, 8])
def test_tables_equal_the_sequential_build_and_jax(wide, width, views):
    """With ``views`` the build reads the group-major views of the
    point-major arrays, as the index's finalize passes them."""
    keys, codes = _keys_codes(23 + width, 6, 1000, 4)
    one = partition.build_partitions_numpy(keys, codes, 64, wide=wide)
    if views:
        keys = np.ascontiguousarray(keys.T).T
        codes = np.transpose(np.ascontiguousarray(
            np.transpose(codes, (1, 0, 2))), (1, 0, 2))
        assert not (keys.flags.c_contiguous or codes.flags.c_contiguous)
    got = partition.build_partitions_numpy(keys, codes, 64, wide=wide,
                                           width=width)
    ref = jpartition.build_partitions_numpy(np.ascontiguousarray(keys),
                                            np.ascontiguousarray(codes), 64,
                                            wide=wide)
    for name, a, b, c in zip(partition.PartitionTable._fields, got, one,
                             ref):
        if c is None:
            assert a is None and b is None, name
            continue
        assert a.dtype == b.dtype == np.asarray(c).dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=name)


def _cfg(**rt):
    kw = dict(refinement_limit=400, max_global_candidates=400, block_size=32,
              routing_mode="scan", rerank_limit=100, encode_backend="cpu",
              scan_capacity_rows=0)
    kw.update(rt)
    return tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3,
                                  seed=13),
        runtime=tconfig.RuntimeConfig(**kw),
        eval=tconfig.EvalConfig(k_variants=(1, 10))).validate()


@pytest.mark.parametrize("backend", ["cpu", "default"])
def test_the_set_up_spans_under_their_roots(tmp_path, monkeypatch, backend):
    """Two ingest batches of 5,000 rows (two chunks each) and the
    finalize: each batch's encode and seal are spans of the stream's root,
    the host encode counts its calls and threads there, and the table
    build is a span of the finalize's root; the scan phase of the finalize
    is named by the layout it built."""
    monkeypatch.setenv("FSPANN_THREADS", "4")
    base = np.random.default_rng(24).normal(size=(10_000, 16)).astype(
        np.float32)
    sys_ = ForwardSecureANNSystem(_cfg(encode_backend=backend),
                                  str(tmp_path / "db"), 16, query_batch=8,
                                  device="cpu")
    profiler.reset()
    try:
        sys_.index_stream(base, batch_size=5_000)
        sys_.finalize_for_search()
        (stream,) = profiler.recent("system.index_stream", 5)
        (final,) = profiler.recent("system.finalize", 5)
        spans = profiler.totals()["spans"]
    finally:
        sys_.store.close()
        profiler.reset()
    assert spans["index.encode"][0] == 2 and spans["store.seal"][0] == 2
    assert spans["system.index_stream"][0] == 1
    for name in ("index.encode", "store.seal", "store.persist"):
        assert 0 < stream[name] < stream["system.index_stream"], name
    assert 0 < final["index.finalize.tables"] < final["system.finalize"]
    assert "index.encode" not in final
    if backend == "cpu":
        assert stream["index.encode.calls"] == 2
        assert 2 <= stream["index.encode.workers"] <= 4
    else:
        assert "index.encode.calls" not in stream
    layouts = [k for k in sys_.index.finalize_sec if k.startswith("scan_")]
    assert layouts == ["scan_upload_native"]


@pytest.mark.parametrize("entry", ["queries", "insert_live"])
def test_queries_and_live_inserts_encode_on_the_callers_thread(
        tmp_path, monkeypatch, entry):
    """Only the set-up's ingest encodes on the pool and holds numpy's BLAS
    at one thread: a query batch and a live insert of 5,000 rows each (two
    chunks) run their encode on the caller's thread, the BLAS untouched."""
    monkeypatch.setenv("FSPANN_THREADS", "4")
    rng = np.random.default_rng(27)
    base = rng.normal(size=(6_000, 16)).astype(np.float32)
    more = rng.normal(size=(5_000, 16)).astype(np.float32)
    sys_ = ForwardSecureANNSystem(_cfg(), str(tmp_path / "db"), 16,
                                  query_batch=8, device="cpu")
    try:
        sys_.index_stream(base, batch_size=6_000)
        sys_.finalize_for_search()
        widths, holds = [], []
        real_map, real_hold = threads.map_threads, coding._one_blas_thread

        def map_threads(fn, items, width):
            widths.append(width)
            return real_map(fn, items, width)

        def hold():
            holds.append(1)
            return real_hold()

        monkeypatch.setattr(threads, "map_threads", map_threads)
        monkeypatch.setattr(coding, "_one_blas_thread", hold)
        if entry == "queries":
            codes, keys = sys_.index.encode_queries(more)
            want = coding.encode_numpy(more, sys_.index._host_bank())
            np.testing.assert_array_equal(codes, want[0])
            np.testing.assert_array_equal(keys, want[1])
        else:
            sys_.insert_live(6_000 + np.arange(len(more)), more)
            assert sys_.index.size == len(base) + len(more)
    finally:
        sys_.store.close()
    assert widths and set(widths) == {1} and not holds


@pytest.mark.parametrize("setup_threads,want", [(0, 4), (1, 1), (3, 3)])
def test_setup_threads_sets_the_set_up_width(tmp_path, monkeypatch,
                                             setup_threads, want):
    """``setup_threads`` 0 takes every core this process may run on (here
    capped at 4 by ``FSPANN_THREADS``), n > 0 takes n: the ingest's encode
    and the table sorts run at that width, and the codes, keys and table
    are those of the one-thread build."""
    monkeypatch.setenv("FSPANN_THREADS", "4")
    monkeypatch.setattr(
        "fspann_tpu_torch.store.parallel_read._usable_cores", lambda: 8)
    base = np.random.default_rng(28).normal(size=(9_000, 16)).astype(
        np.float32)
    real_map = threads.map_threads
    built = {}
    for n in (1, setup_threads):
        widths = []

        def map_threads(fn, items, width):
            widths.append(width)
            return real_map(fn, items, width)

        monkeypatch.setattr(threads, "map_threads", map_threads)
        sys_ = ForwardSecureANNSystem(_cfg(setup_threads=n),
                                      str(tmp_path / f"db{n}"), 16,
                                      query_batch=8, device="cpu")
        try:
            sys_.index_stream(base, batch_size=9_000)
            sys_.finalize_for_search()
            built[n] = (sys_.index._table_host, widths)
        finally:
            sys_.store.close()
    table, widths = built[setup_threads]
    # one encode of three chunks, then the table sorts of 3 x 2 groups
    assert widths == [min(3, want), min(6, want)]
    for name, a, b in zip(partition.PartitionTable._fields, built[1][0],
                          table):
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_setup_threads_below_zero_is_refused(tmp_path):
    sys_ = ForwardSecureANNSystem(_cfg(setup_threads=-1),
                                  str(tmp_path / "db"), 16, query_batch=8,
                                  device="cpu")
    try:
        with pytest.raises(ValueError, match="setup_threads"):
            sys_.index_stream(np.zeros((10, 16), np.float32))
            sys_.finalize_for_search()
    finally:
        sys_.store.close()
