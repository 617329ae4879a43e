"""The pooled candidate read (``fspann_tpu_torch/store/parallel_read.py``,
``csrc/native/open_pool.c``) against the carried ``PointStore.load_*``
methods, bit for bit, and the life of its process-wide thread pool: several
callers at once, a forked child, the interpreter's exit, and the query
service's choice of reader by the store's type."""

import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.crypto.keys import KeyManager
from fspann_tpu_torch.store import parallel_read
from fspann_tpu_torch.store.point_store import PointStore
from fspann_tpu_torch.store.sharded_store import ShardedPointStore
from fspann_tpu_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 3000, 24
TAG_REL = 32                  # + the body: the tag's place in a record


def _store(path, dtype, rng):
    """A store whose ids hold every case the read must tell apart: two live
    key versions after a rotation, tombstones, a stale offset past the
    arena's end, one that overruns it by a byte, and a corrupted tag.
    Returns (store, {case: ids})."""
    km = KeyManager(os.path.join(path, "keys.blob"))
    store = PointStore(os.path.join(path, "store"), km, D, dtype=dtype)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    store.insert_batch(np.arange(N // 2), vecs[:N // 2])
    km.rotate()
    store.insert_batch(np.arange(N // 2, N), vecs[N // 2:])
    dead = np.arange(5, N, 97)
    store.delete(dead)
    size = store._reader(km.current_version).size
    stale, overrun, bad_tag = N - 3, N - 5, N - 7
    store.meta._off[stale] = size + 64
    store.meta._off[overrun] = size - (TAG_REL + store._body + 16) + 1
    off = int(store.meta._off[bad_tag]) + TAG_REL + store._body
    path_v = store._arena_path(km.current_version)
    with open(path_v, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0x5A]))
    cases = {"dead": dead, "stale": np.array([stale, overrun]),
             "bad_tag": np.array([bad_tag]),
             "negative": np.array([-1, -7, -(2 ** 40)]),
             "past_capacity": np.array([N, len(store.meta._kv),
                                        10 ** 9, 2 ** 40])}
    return store, cases


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    rng = np.random.default_rng(15)
    out = {}
    for dtype in ("f32", "f16", "i8"):
        out[dtype] = _store(str(tmp_path_factory.mktemp(dtype)), dtype, rng)
    yield out
    for store, _ in out.values():
        store.close()


def _ids(cases, n, seed):
    """n candidate ids: every special case first, then live ids of both
    key versions, shuffled."""
    rng = np.random.default_rng(seed)
    special = np.concatenate(list(cases.values()))
    ids = np.concatenate([special, rng.integers(0, N, n)])[:n]
    return rng.permutation(ids)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype", ["f32", "f16", "i8"])
@pytest.mark.parametrize("width", [1, 2, 3, 8, None])
@pytest.mark.parametrize("size", ["below", "above"])
@pytest.mark.parametrize("mode", ["score", "decrypt"])
def test_reader_equals_the_carried_store(stores, dtype, width, size, mode):
    store, cases = stores[dtype]
    n = parallel_read.INLINE_BELOW // 2 if size == "below" else 2000
    ids = _ids(cases, n, seed=len(dtype) + n)
    assert n < parallel_read.INLINE_BELOW if size == "below" else \
        n > parallel_read.INLINE_BELOW
    if mode == "score":
        rpq = 50
        q = np.random.default_rng(3).normal(
            size=(-(-n // rpq), D)).astype(np.float32)
        # stale values in the buffers: misses must be zeroed by both
        want_n, want_d = np.full(n, 7.0, np.float32), np.full(
            n, -3.0, np.float32)
        got_n, got_d = want_n.copy(), want_d.copy()
        want_ok = store.load_score_batch(ids, q, rpq, want_n, want_d)
        got_ok = parallel_read.score_batch(store, ids, q, rpq, got_n, got_d,
                                           width=width)
        outs = [(want_n, got_n), (want_d, got_d)]
    else:
        # a reused staging buffer: rows that never reach an open keep
        # their stale bytes in both
        stale = np.random.default_rng(4).normal(size=(n + 5, D)).astype(
            np.float32)
        want_v, got_v = stale.copy(), stale.copy()
        want_n, got_n = np.full(n, 9.0, np.float32), np.full(n, 9.0,
                                                             np.float32)
        want_v, want_ok = store.load_decrypt_batch(ids, out=want_v,
                                                   norms_out=want_n)
        got_v, got_ok = parallel_read.decrypt_batch(store, ids, out=got_v,
                                                    norms_out=got_n,
                                                    width=width)
        fresh_v, fresh_ok = store.load_decrypt_batch(ids)
        new_v, new_ok = parallel_read.decrypt_batch(store, ids, width=width)
        outs = [(want_v, got_v), (want_n, got_n), (fresh_v, new_v),
                (fresh_ok, new_ok)]
    assert got_ok.dtype == bool and _bits(got_ok).tobytes() == \
        _bits(want_ok).tobytes()
    for want, got in outs:
        assert want.shape == got.shape
        assert _bits(want).tobytes() == _bits(got).tobytes()
    # the cases are there: misses where they must be, both versions read
    for case in ("dead", "stale", "bad_tag", "negative", "past_capacity"):
        assert not got_ok[np.isin(ids, cases[case])].any(), case
    kv = store.meta._kv[np.clip(ids, 0, N - 1)]
    assert got_ok[(kv == 1) & (ids >= 0)].any() and \
        got_ok[(kv == 2) & (ids >= 0)].any()


def test_small_reads_run_on_the_callers_thread(stores):
    """Below the threshold one thread reads; above it the pool is posted,
    and the threads that took a chunk are counted (how many of the woken
    workers come in time depends on the host's scheduler)."""
    store, cases = stores["f16"]
    q = np.zeros((4, D), np.float32)
    width = parallel_read.default_width()
    for n, most in ((parallel_read.INLINE_BELOW - 1, 1), (2000, width)):
        ids = _ids(cases, n, seed=n)
        profiler.reset()
        norms, dots = np.zeros(n, np.float32), np.zeros(n, np.float32)
        with profiler.span("root"):
            parallel_read.score_batch(store, ids, q, -(-n // 4), norms,
                                      dots)
        workers = profiler.recent("root", 1)[0]["store.open.workers"]
        assert 1 <= workers <= most
    assert parallel_read.pool_threads() >= width - 1
    profiler.reset()


def test_four_threads_on_two_stores_give_the_serial_results(stores):
    pairs = [stores["f32"], stores["i8"]]
    q = np.random.default_rng(5).normal(size=(40, D)).astype(np.float32)
    jobs = []
    for i in range(4):
        store, cases = pairs[i % 2]
        ids = _ids(cases, 2000, seed=100 + i)
        norms, dots = np.zeros(2000, np.float32), np.zeros(2000, np.float32)
        ok = store.load_score_batch(ids, q, 50, norms, dots)
        jobs.append((store, ids, (ok, norms, dots)))
    bad = []

    def worker(store, ids, want):
        for _ in range(25):
            norms = np.zeros(2000, np.float32)
            dots = np.zeros(2000, np.float32)
            ok = parallel_read.score_batch(store, ids, q, 50, norms, dots,
                                           width=8)
            if not all(np.array_equal(_bits(a), _bits(b))
                       for a, b in zip((ok, norms, dots), want)):
                bad.append(ids[:3])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=j) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad


def test_a_forked_child_reads_with_a_pool_of_its_own(stores):
    store, cases = stores["f16"]
    ids = _ids(cases, 2000, seed=9)
    q = np.random.default_rng(6).normal(size=(40, D)).astype(np.float32)
    norms, dots = np.zeros(2000, np.float32), np.zeros(2000, np.float32)
    want = store.load_score_batch(ids, q, 50, norms, dots)
    # the parent's pool is running before the fork
    parallel_read.score_batch(store, ids, q, 50, np.zeros(2000, np.float32),
                              np.zeros(2000, np.float32), width=4)
    assert parallel_read.pool_threads() >= 3
    # the child touches neither the interpreter's other threads nor JAX:
    # the warnings about forking a threaded process do not apply
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pid = os.fork()
    if pid == 0:
        code = 1
        try:
            n2, d2 = np.zeros(2000, np.float32), np.zeros(2000, np.float32)
            ok = parallel_read.score_batch(store, ids, q, 50, n2, d2,
                                           width=4)
            same = np.array_equal(ok, want) and np.array_equal(
                _bits(n2), _bits(norms)) and np.array_equal(
                _bits(d2), _bits(dots))
            code = 0 if same and parallel_read.pool_threads() == 3 else 1
        finally:
            os._exit(code)
    deadline = time.monotonic() + 120
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        assert time.monotonic() < deadline, "the forked child hung"
        time.sleep(0.05)
    assert os.waitstatus_to_exitcode(status) == 0


def test_the_process_exits_with_the_pool_idle(tmp_path):
    code = (
        "import numpy as np, os\n"
        "from fspann_tpu_torch.crypto.keys import KeyManager\n"
        "from fspann_tpu_torch.store.point_store import PointStore\n"
        "from fspann_tpu_torch.store import parallel_read\n"
        f"p = {str(tmp_path)!r}\n"
        "s = PointStore(os.path.join(p, 's'), "
        "KeyManager(os.path.join(p, 'k.blob')), 8)\n"
        "s.insert_batch(np.arange(4000), np.ones((4000, 8), np.float32))\n"
        "v, ok = parallel_read.decrypt_batch(s, np.arange(4000), width=6)\n"
        "assert ok.all() and (v == 1).all()\n"
        "print(parallel_read.pool_threads())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == 5
    assert time.monotonic() - t0 < 300


# -- the query service's reader ----------------------------------------------

QN, QD, QB = 900, 16, 8


def _system(tmp_path, backend):
    cfg = tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3,
                                  seed=13),
        runtime=tconfig.RuntimeConfig(
            refinement_limit=400, max_global_candidates=400, block_size=32,
            routing_mode="scan", rerank_limit=100, encode_backend="cpu",
            scan_native="off", scan_capacity_rows=0,
            refine_backend=backend),
        eval=tconfig.EvalConfig(k_variants=(1, 10))).validate()
    rng = np.random.default_rng(7)
    base = rng.normal(size=(QN, QD)).astype(np.float32)
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "db"), QD,
                                  query_batch=QB, device="cpu")
    sys_.index_stream(base, batch_size=300)
    sys_.finalize_for_search()
    queries = base[rng.integers(0, QN, 2 * QB)] + 0.01
    return sys_, base, queries


@pytest.mark.parametrize("backend", ["host", "device"])
def test_service_reads_a_point_store_on_the_pool_and_others_their_way(
        tmp_path, monkeypatch, backend):
    sys_, base, queries = _system(tmp_path, backend)
    pooled, carried = [], []
    for name in ("score_batch", "decrypt_batch"):
        real = getattr(parallel_read, name)

        def spy(*a, _real=real, **kw):
            pooled.append(1)
            return _real(*a, **kw)
        monkeypatch.setattr(parallel_read, name, spy)
    for name in ("load_score_batch", "load_decrypt_batch"):
        real = getattr(PointStore, name)

        def spy_store(self, *a, _real=real, **kw):
            carried.append(1)
            return _real(self, *a, **kw)
        monkeypatch.setattr(PointStore, name, spy_store)

    def serve():
        toks = [sys_.tokens.create_batch(queries[s:s + QB], 10)
                for s in range(0, len(queries), QB)]
        return sys_.query_service.search_batches(toks)

    try:
        profiler.reset()
        first = serve()
        assert len(pooled) == 2 and not carried
        root = profiler.recent("query.search_batches", 1)[0]
        assert root["store.open.workers"] >= 2
        assert profiler.totals()["counters"]["store.open.workers"] == \
            root["store.open.workers"]

        sharded = ShardedPointStore(str(tmp_path / "sharded"), sys_.km, QD,
                                    num_shards=4, dtype=sys_.store.dtype)
        sharded.insert_batch(np.arange(QN), base)
        sys_.query_service.store = sharded
        pooled.clear()
        second = serve()
        # the sharded store reads through its own method, whose shards
        # are PointStores: the carried method, never the pool
        assert not pooled and len(carried) >= 2
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)
        for s in sharded.shards:
            s.close()
    finally:
        profiler.reset()
        sys_.shutdown()
