"""The port's candidate read, ``PointStore.load_*`` (one native pass on a
pool of host threads: ``fspann_tpu_torch/store/parallel_read.py``,
``csrc/native/open_pool.c``), against the JAX package's ``PointStore.load_*``
over the same store directory, bit for bit, and the life of its
process-wide thread pool: several callers at once, a forked child, the
interpreter's exit, and the query service reading every store through its
``load_*`` methods."""

import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from fspann_tpu.crypto.keys import KeyManager as JKeys
from fspann_tpu.store.point_store import PointStore as JStore
from fspann_tpu.store.sharded_store import ShardedPointStore as JSharded
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
    arena's end, one that overruns it by a byte, and a corrupted tag.  The
    JAX package's store is opened over the same directory and key file,
    with the same offsets edited in memory.  Returns (store, JAX store,
    {case: ids})."""
    km = KeyManager(os.path.join(path, "keys.blob"))
    store = PointStore(os.path.join(path, "store"), km, D, dtype=dtype)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    store.insert_batch(np.arange(N // 2), vecs[:N // 2])
    km.rotate()
    store.insert_batch(np.arange(N // 2, N), vecs[N // 2:])
    dead = np.arange(5, N, 97)
    store.delete(dead)
    ref = JStore(os.path.join(path, "store"),
                 JKeys(os.path.join(path, "keys.blob")), D, dtype=dtype)
    size = store._reader(km.current_version).size
    stale, overrun, bad_tag = N - 3, N - 5, N - 7
    for s in (store, ref):
        s.meta._off[stale] = size + 64
        s.meta._off[overrun] = size - (TAG_REL + store._body + 16) + 1
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
    return store, ref, cases


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    rng = np.random.default_rng(15)
    out = {}
    for dtype in ("f32", "f16", "i8"):
        out[dtype] = _store(str(tmp_path_factory.mktemp(dtype)), dtype, rng)
    yield out
    for store, ref, _ in out.values():
        store.close()
        ref.close()


def _threads(monkeypatch, width):
    """Caps the read's threads at ``width`` (None: every usable core)."""
    if width is None:
        monkeypatch.delenv("FSPANN_THREADS", raising=False)
    else:
        monkeypatch.setenv("FSPANN_THREADS", str(width))


def _ids(cases, n, seed):
    """n candidate ids: every special case first, then live ids of both
    key versions, shuffled."""
    rng = np.random.default_rng(seed)
    special = np.concatenate(list(cases.values()))
    ids = np.concatenate([special, rng.integers(0, N, n)])[:n]
    return rng.permutation(ids)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _counted(call):
    """``call()`` and the threads that took a chunk of its read."""
    before = profiler.totals()["counters"].get("store.open.workers", 0)
    out = call()
    return out, profiler.totals()["counters"].get(
        "store.open.workers", 0) - before


# seconds for which a pooled case reads again until more than one thread
# has taken a chunk of one read: whether a woken worker comes before the
# caller has taken every chunk is up to the host's scheduler (on a host of
# virtual cores, the first read to share its chunks came after 1 to 540
# reads of 512 candidates)
POOL_WAIT_S = 30


@pytest.mark.parametrize("dtype", ["f32", "f16", "i8"])
@pytest.mark.parametrize("width", [1, 2, 3, 8, None])
@pytest.mark.parametrize("size", ["below", "above"])
@pytest.mark.parametrize("mode", ["score", "decrypt", "score-rows",
                                  "decrypt-rows"])
def test_reader_equals_the_carried_store(stores, monkeypatch, dtype, width,
                                         size, mode):
    """The port's read against the source it is carried from, the JAX
    package's store.  Below :data:`INLINE_BELOW` a read runs on the
    caller's thread alone, so at widths above 1 the small read lowers the
    threshold to 0 and goes to the pool as well; wherever the pool may take
    part, some read of the case is shared by more than one thread."""
    store, ref, cases = stores[dtype]
    _threads(monkeypatch, width)
    n = parallel_read.INLINE_BELOW // 2 if size == "below" else 2000
    ids = _ids(cases, n, seed=len(dtype) + n)
    assert n < parallel_read.INLINE_BELOW if size == "below" else \
        n > parallel_read.INLINE_BELOW
    if width != 1:
        monkeypatch.setattr(parallel_read, "INLINE_BELOW", 0)
    # rows=: every slot written at a row of its own among n + 7, so that
    # seven rows stay untouched
    rows = np.random.default_rng(n).permutation(n + 7)[:n] \
        if mode.endswith("-rows") else None
    n_out = n if rows is None else n + 7
    kw = {} if rows is None else {"rows": rows}
    if mode.startswith("score"):
        rpq = 50
        q = np.random.default_rng(3).normal(
            size=(-(-n_out // rpq), D)).astype(np.float32)

        def read(s):
            # stale values in the buffers: misses must be zeroed by both
            norms = np.full(n_out, 7.0, np.float32)
            dots = np.full(n_out, -3.0, np.float32)
            ok, workers = _counted(lambda: s.load_score_batch(
                ids, q, rpq, norms, dots, **kw))
            return ok, [norms, dots], workers
    else:
        # a reused staging buffer: rows that never reach an open keep
        # their stale bytes in both
        stale = np.random.default_rng(4).normal(size=(n_out + 5, D)).astype(
            np.float32)

        def read(s):
            norms = np.full(n_out, 9.0, np.float32)
            (vecs, ok), workers = _counted(lambda: s.load_decrypt_batch(
                ids, out=stale.copy(), norms_out=norms, **kw))
            outs = [vecs, norms]
            if rows is None:
                outs += list(s.load_decrypt_batch(ids))
            return ok, outs, workers
    want_ok, want, _ = read(ref)
    pooled = parallel_read.default_width() > 1
    most, deadline = 0, time.monotonic() + POOL_WAIT_S
    while True:
        got_ok, got, workers = read(store)
        assert got_ok.dtype == bool and _bits(got_ok).tobytes() == \
            _bits(want_ok).tobytes()
        for w, g in zip(want, got):
            assert w.shape == g.shape
            assert _bits(w).tobytes() == _bits(g).tobytes()
        most = max(most, workers)
        if not pooled or most > 1 or time.monotonic() > deadline:
            break
    assert most > 1 if pooled else most == 1
    # the cases are there: misses where they must be, both versions read
    for case in ("dead", "stale", "bad_tag", "negative", "past_capacity"):
        assert not got_ok[np.isin(ids, cases[case])].any(), case
    kv = store.meta._kv[np.clip(ids, 0, N - 1)]
    assert got_ok[(kv == 1) & (ids >= 0)].any() and \
        got_ok[(kv == 2) & (ids >= 0)].any()


def test_sharded_reads_equal_the_jax_store(tmp_path, monkeypatch):
    """The sharded store's shards read through ``rows=``: both modes equal
    the JAX package's sharded store over the same shards, a rotation,
    tombstones, pads and an unprobed shard among the candidates."""
    monkeypatch.delenv("FSPANN_THREADS", raising=False)
    rng = np.random.default_rng(18)
    n, d = 6000, 16
    km = KeyManager(str(tmp_path / "keys.blob"))
    store = ShardedPointStore(str(tmp_path / "db"), km, d, num_shards=3,
                              dtype="f16")
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store.insert_batch(np.arange(n // 2), vecs[:n // 2])
    km.rotate()
    store.insert_batch(np.arange(n // 2, n), vecs[n // 2:])
    store.delete(np.arange(0, n, 53))
    ref = JSharded(str(tmp_path / "db"), JKeys(str(tmp_path / "keys.blob")),
                   d, num_shards=3, dtype="f16")
    try:
        ids = rng.permutation(np.concatenate([
            rng.integers(0, n, 5000), np.full(40, -1), [n, n + 9]]))
        q = rng.normal(size=(-(-len(ids) // 100), d)).astype(np.float32)
        for probe in (None, 2):
            got = []
            for s in (ref, store):
                out = np.full((len(ids) + 3, d), 5.0, np.float32)
                norms = np.full(len(ids) + 3, 9.0, np.float32)
                _, ok = s.load_decrypt_batch(ids, probe_shards=probe,
                                             out=out, norms_out=norms)
                sn = np.full(len(ids), 7.0, np.float32)
                sd = np.full(len(ids), -3.0, np.float32)
                sok = s.load_score_batch(ids, q, 100, sn, sd,
                                         probe_shards=probe)
                got.append((ok, out, norms, sok, sn, sd))
            for want, have in zip(*got):
                assert _bits(have).tobytes() == _bits(want).tobytes()
            assert got[1][0].sum() > len(ids) // 3
    finally:
        store.close()
        ref.close()


def test_a_missing_arena_fails_only_its_own_records(tmp_path):
    """A live key version whose arena file is gone fails a read that
    touches one of its records, as the JAX package's does, and leaves a
    read of the other version's records as the JAX package leaves it."""
    km = KeyManager(str(tmp_path / "keys.blob"))
    store = PointStore(str(tmp_path / "store"), km, 8)
    vecs = np.random.default_rng(11).normal(size=(200, 8)).astype(np.float32)
    store.insert_batch(np.arange(100), vecs[:100])
    km.rotate()
    store.insert_batch(np.arange(100, 200), vecs[100:])
    ref = JStore(str(tmp_path / "store"), JKeys(str(tmp_path / "keys.blob")),
                 8)
    try:
        os.remove(store._arena_path(1))
        for s in (ref, store):
            got, ok = s.load_decrypt_batch(np.arange(100, 200))
            assert ok.all() and np.array_equal(got, vecs[100:])
            with pytest.raises(FileNotFoundError):
                s.load_decrypt_batch(np.array([150, 3]))
    finally:
        store.close()
        ref.close()


def test_negative_rows_are_refused(stores):
    """``rows=`` names output rows the native pass writes unchecked."""
    store, _, _ = stores["f32"]
    ids, rows = np.arange(4), np.array([0, 1, -1, 2])
    buf = np.zeros((4, D), np.float32)
    with pytest.raises(ValueError):
        store.load_decrypt_batch(ids, out=buf, rows=rows)
    with pytest.raises(ValueError):
        store.load_score_batch(ids, np.zeros((1, D), np.float32), 4,
                               np.zeros(4, np.float32),
                               np.zeros(4, np.float32), rows=rows)


def test_small_reads_run_on_the_callers_thread(stores, monkeypatch):
    """Below the threshold one thread reads; above it the pool is posted,
    and the threads that took a chunk are counted (how many of the woken
    workers come in time depends on the host's scheduler)."""
    store, _, cases = stores["f16"]
    _threads(monkeypatch, None)
    q = np.zeros((4, D), np.float32)
    width = parallel_read.default_width()
    for n, most in ((parallel_read.INLINE_BELOW - 1, 1), (2000, width)):
        ids = _ids(cases, n, seed=n)
        profiler.reset()
        norms, dots = np.zeros(n, np.float32), np.zeros(n, np.float32)
        with profiler.span("root"):
            store.load_score_batch(ids, q, -(-n // 4), norms, dots)
        workers = profiler.recent("root", 1)[0]["store.open.workers"]
        assert 1 <= workers <= most
    assert parallel_read.pool_threads() >= width - 1
    profiler.reset()


def test_four_threads_on_two_stores_give_the_serial_results(stores,
                                                            monkeypatch):
    pairs = [stores["f32"], stores["i8"]]
    q = np.random.default_rng(5).normal(size=(40, D)).astype(np.float32)
    jobs = []
    for i in range(4):
        store, ref, cases = pairs[i % 2]
        ids = _ids(cases, 2000, seed=100 + i)
        norms, dots = np.zeros(2000, np.float32), np.zeros(2000, np.float32)
        ok = ref.load_score_batch(ids, q, 50, norms, dots)
        jobs.append((store, ids, (ok, norms, dots)))
    _threads(monkeypatch, 8)
    bad = []

    def worker(store, ids, want):
        for _ in range(25):
            norms = np.zeros(2000, np.float32)
            dots = np.zeros(2000, np.float32)
            ok = store.load_score_batch(ids, q, 50, norms, dots)
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


def test_a_forked_child_reads_with_a_pool_of_its_own(stores, monkeypatch):
    store, ref, cases = stores["f16"]
    ids = _ids(cases, 2000, seed=9)
    q = np.random.default_rng(6).normal(size=(40, D)).astype(np.float32)
    norms, dots = np.zeros(2000, np.float32), np.zeros(2000, np.float32)
    want = ref.load_score_batch(ids, q, 50, norms, dots)
    # the parent's pool is running before the fork
    _threads(monkeypatch, 4)
    store.load_score_batch(ids, q, 50, np.zeros(2000, np.float32),
                           np.zeros(2000, np.float32))
    width = parallel_read.default_width()
    assert parallel_read.pool_threads() >= width - 1
    # the child touches neither the interpreter's other threads nor JAX:
    # the warnings about forking a threaded process do not apply
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pid = os.fork()
    if pid == 0:
        code = 1
        try:
            n2, d2 = np.zeros(2000, np.float32), np.zeros(2000, np.float32)
            ok = store.load_score_batch(ids, q, 50, n2, d2)
            same = np.array_equal(ok, want) and np.array_equal(
                _bits(n2), _bits(norms)) and np.array_equal(
                _bits(d2), _bits(dots))
            code = 0 if same and parallel_read.pool_threads() == width - 1 \
                else 1
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
        "v, ok = s.load_decrypt_batch(np.arange(4000))\n"
        "assert ok.all() and (v == 1).all()\n"
        "print(parallel_read.pool_threads(), parallel_read.default_width())\n")
    env = dict(os.environ, PYTHONPATH=REPO, FSPANN_THREADS="6")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    threads, width = map(int, proc.stdout.split()[-2:])
    assert width == min(6, len(os.sched_getaffinity(0)))
    assert threads == width - 1
    assert time.monotonic() - t0 < 300


# -- the query service's reader ----------------------------------------------

QN, QD, QB = 900, 16, 16


def _system(tmp_path, backend):
    cfg = tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3,
                                  seed=13),
        runtime=tconfig.RuntimeConfig(
            refinement_limit=400, max_global_candidates=400, block_size=32,
            routing_mode="scan", rerank_limit=200, encode_backend="cpu",
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
    """The query service calls its store's ``load_*`` and nothing else: a
    ``PointStore`` reads a batch above :data:`INLINE_BELOW` on the pool,
    and so does each shard of a ``ShardedPointStore`` read one shard at a
    time; both serve the same results."""
    monkeypatch.delenv("FSPANN_THREADS", raising=False)
    monkeypatch.setenv("FSPANN_SHARD_THREADS", "1")
    sys_, base, queries = _system(tmp_path, backend)
    calls = {PointStore: [], ShardedPointStore: []}
    for cls, seen in calls.items():
        for name in ("load_score_batch", "load_decrypt_batch"):
            real = getattr(cls, name)

            def spy(self, ids, *a, _real=real, _seen=seen, **kw):
                _seen.append(len(ids))
                return _real(self, ids, *a, **kw)
            monkeypatch.setattr(cls, name, spy)

    def serve():
        toks = [sys_.tokens.create_batch(queries[s:s + QB], 10)
                for s in range(0, len(queries), QB)]
        return sys_.query_service.search_batches(toks)

    def workers():
        return profiler.recent("query.search_batches", 1)[0][
            "store.open.workers"]

    try:
        profiler.reset()
        first = serve()
        assert len(calls[PointStore]) == 2
        assert min(calls[PointStore]) > parallel_read.INLINE_BELOW
        assert workers() >= 2
        assert profiler.totals()["counters"]["store.open.workers"] == \
            workers()

        sharded = ShardedPointStore(str(tmp_path / "sharded"), sys_.km, QD,
                                    num_shards=2, dtype=sys_.store.dtype)
        sharded.insert_batch(np.arange(QN), base)
        sys_.query_service.store = sharded
        calls[PointStore].clear()
        second = serve()
        # one call of the sharded store a batch, one of each shard under it
        assert len(calls[ShardedPointStore]) == 2
        assert len(calls[PointStore]) == 4
        assert max(calls[PointStore]) > parallel_read.INLINE_BELOW
        assert workers() >= 2
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)
        for s in sharded.shards:
            s.close()
    finally:
        profiler.reset()
        sys_.shutdown()
