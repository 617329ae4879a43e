"""The query service's touched set (``fspann_tpu_torch/query/touched.py``)
against recording each batch whole, on the CPU.

Recording a batch whole is what the service did before the map, and what it
still does for sparse ids and for immediate re-encryption: ``np.unique`` of
the batch's touched ids, then ``ReencryptionTracker.record``.  Here that
path runs in the test, on a second tracker fed the same batches, and every
drain of the service's tracker must return exactly the list the second
tracker drains."""

import numpy as np
import pytest

from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.crypto.rotation import ReencryptionTracker
from fspann_tpu_torch.query.touched import TouchedMap
from fspann_tpu_torch.utils import profiler

N, D, QB, K = 900, 16, 4, 10


def _cfg(**reenc):
    return tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=tconfig.RuntimeConfig(
            refinement_limit=400, max_global_candidates=400, block_size=32,
            routing_mode="scan", rerank_limit=100, encode_backend="cpu"),
        reencryption=tconfig.ReencryptionConfig(**reenc),
        eval=tconfig.EvalConfig(k_variants=(1, 10))).validate()


def _system(path, base, ids=None, **reenc):
    sys_ = ForwardSecureANNSystem(_cfg(**reenc), str(path), D,
                                  query_batch=QB, device="cpu")
    if ids is None:
        sys_.index_stream(base, batch_size=300)
    else:
        sys_.batch_insert(ids, base)
    sys_.finalize_for_search()
    return sys_


def _whole(parts):
    """Today's record of one batch: its sorted unique touched ids."""
    return np.unique(np.concatenate(parts))


class Shadow:
    """Feeds a second tracker each batch whole, as the service did before
    the map, and holds every drain of the system's tracker to its drain."""

    def __init__(self, sys_):
        self.ref = ReencryptionTracker()
        self.drains = []
        self.batches = 0
        qs = sys_.query_service
        forward = qs._touched.record

        def record(parts, tracker, rows):
            self.ref.record(_whole(parts))
            self.batches += 1
            return forward(parts, tracker, rows)

        qs._touched.record = record
        tracker = sys_.tracker
        drain = tracker.drain

        def checked_drain():
            got = drain()
            assert got == self.ref.drain()
            self.drains.append(got)
            return got

        tracker.drain = checked_drain


def _search(sys_, queries, calls=3):
    tokens = sys_.tokens.create_batch(queries, K)
    batches = [tokens[i:i + QB] for i in range(0, len(tokens), QB)]
    return sys_.query_service.search_batches(batches * calls)


@pytest.fixture
def data(rng):
    centers = rng.normal(size=(16, D)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, N)] + \
        rng.normal(size=(N, D)).astype(np.float32)
    return base, rng


# -- the map alone, on random batch sequences ---------------------------------


OPS = ["batches", "drains", "unique_counts", "growth", "retries", "mixed"]


@pytest.mark.parametrize("ops", OPS)
def test_map_drains_equal_whole_batch_records(ops):
    """Random batches of ids (Zipf-clustered, so ids repeat across
    batches), with drains, compactions (``unique_count``), an id space that
    grows past the map, and batches of two parts (a retry pass), drain to
    the same lists as whole-batch records."""
    rng = np.random.default_rng(OPS.index(ops))
    tracker, ref, touched = ReencryptionTracker(), ReencryptionTracker(), \
        TouchedMap()
    rows = 5_000
    hot = rng.integers(0, rows, 300)
    for b in range(120):
        if ops in ("growth", "mixed") and b in (40, 80):
            rows += 4_000          # inserts raise the largest id
        n_parts = 2 if ops in ("retries", "mixed") and b % 3 == 0 else 1
        parts = []
        for _ in range(n_parts):
            n = int(rng.integers(0, 400))
            ids = np.where(rng.random(n) < 0.7, rng.choice(hot, n),
                           rng.integers(0, rows, n))
            parts.append(ids.astype(rng.choice([np.int32, np.int64])))
        assert touched.record(parts, tracker, rows)
        ref.record(_whole(parts))
        if ops in ("drains", "mixed") and rng.random() < 0.1:
            assert tracker.drain() == ref.drain()
        if ops in ("unique_counts", "mixed") and rng.random() < 0.1:
            assert tracker.unique_count() == ref.unique_count()
    if ops in ("growth", "mixed"):
        assert len(touched._marks) > 5_000
    assert len(touched._marks) <= 4 * rows
    assert tracker.drain() == ref.drain()
    assert tracker.drain() == ref.drain() == []


def test_map_retains_each_id_once_over_repeats():
    """200 batches that repeat the same ids: the tracker retains each
    distinct id once, where whole-batch records retain every batch."""
    rng = np.random.default_rng(7)
    tracker, touched = ReencryptionTracker(), TouchedMap()
    batch = rng.integers(0, 50_000, 20_000)
    for _ in range(200):
        touched.record([batch], tracker, 50_000)
    assert sum(len(p) for p in tracker._parts) == len(np.unique(batch))
    assert tracker.drain() == np.unique(batch).tolist()


# -- through the facade --------------------------------------------------------


@pytest.mark.parametrize("case", [
    "batches", "reencryption", "unique_count", "insert_live", "retry",
    "restore"])
def test_facade_drains_equal_whole_batch_records(tmp_path, data, case):
    """A small system's batches, interleaved with the end-of-run
    re-encryption (which drains), ``unique_count`` (which compacts), live
    inserts past the map, a retry pass and a restore: every drain equals
    whole-batch records, and search results do not depend on the map."""
    base, rng = data
    sys_ = _system(tmp_path / "db", base)
    try:
        shadow = Shadow(sys_)
        qs = sys_.query_service
        for step in range(3):
            queries = base[rng.integers(0, N, 8)] + 0.05
            if case == "insert_live" and step:
                new = rng.normal(size=(64, D)).astype(np.float32) + 30 * step
                first = N + 64 * (step - 1)
                sys_.insert_live(np.arange(first, first + 64), new)
                queries = new[:8] + 0.01
            if case == "retry" and step == 1:
                sys_.store.delete(np.arange(40, N))   # store side only
            res = _search(sys_, queries)
            if case == "retry" and step == 1:
                assert any(s.retried for r in res for s in r.stats)
            if case == "reencryption":
                report = sys_.run_selective_reencryption()
                assert report["new_version"] == step + 2
            if case == "unique_count":
                assert sys_.tracker.unique_count() == \
                    shadow.ref.unique_count()
        if case == "insert_live":
            assert len(qs._touched._marks) > N
        if case == "restore":
            sys_.shutdown()
            sys_ = ForwardSecureANNSystem(_cfg(), str(tmp_path / "db"), D,
                                          query_batch=QB, device="cpu")
            assert sys_.restore_index_from_disk() == N
            shadow = Shadow(sys_)
        _search(sys_, base[rng.integers(0, N, 8)] + 0.05)
        assert sys_.tracker.drain()
        assert shadow.batches and all(shadow.drains[-1:])
        if case == "reencryption":
            assert len(shadow.drains) == 4
    finally:
        sys_.shutdown()


def test_map_leaves_results_and_stats_unchanged(tmp_path, data):
    """The same tokens with the map and with whole-batch records give the
    same ids, distances and ``SearchStats`` (but ``track_ns``, ``server_ns``
    and the other times)."""
    base, rng = data
    sys_ = _system(tmp_path / "db", base)
    try:
        tokens = sys_.tokens.create_batch(base[rng.integers(0, N, 8)], K)
        qs = sys_.query_service
        with_map = qs.search_batch(tokens)
        qs._touched.record = lambda parts, tracker, rows: False
        without = qs.search_batch(tokens)
        np.testing.assert_array_equal(with_map.ids, without.ids)
        np.testing.assert_array_equal(with_map.distances, without.distances)
        for a, b in zip(with_map.stats, without.stats):
            for f in ("cand_raw", "cand_unique", "cand_refined",
                      "cand_decrypted", "returned", "retried"):
                assert getattr(a, f) == getattr(b, f)
    finally:
        sys_.shutdown()


# -- where the map is not used -------------------------------------------------


def _root_counters():
    (root,) = profiler.recent("query.search_batches", 1)
    return {k: v for k, v in root.items() if k.startswith("query.track.")}


def test_sparse_ids_record_each_batch_whole(tmp_path, data):
    """Ids far sparser than the rows (here 1,000 apart) keep the whole-batch
    record: no counters, and the tracker receives each batch's sorted
    unique ids, as before the map."""
    base, rng = data
    sys_ = _system(tmp_path / "db", base, ids=np.arange(N) * 1000)
    try:
        shadow = Shadow(sys_)
        before = list(sys_.tracker._parts)
        sys_.query_service.search_batch(
            sys_.tokens.create_batch(base[rng.integers(0, N, QB)], K))
        assert _root_counters() == {}
        assert len(sys_.query_service._touched._marks) == 0
        (got,) = sys_.tracker._parts[len(before):]
        np.testing.assert_array_equal(got, shadow.ref._parts[-1])
        assert sys_.tracker.drain() and shadow.batches == 1
    finally:
        sys_.shutdown()


def test_immediate_mode_gets_the_whole_batch(tmp_path, data, monkeypatch):
    """``reencryption.mode="immediate"``: ``on_touched`` receives each
    batch's sorted unique touched ids, the map is not consulted and no
    counter is kept; the same tokens with the hook taken away give the map
    the same ids."""
    base, rng = data
    sys_ = _system(tmp_path / "db", base, mode="immediate")
    try:
        qs = sys_.query_service
        seen = []
        migrate = qs.on_touched

        def hook(ids):
            seen.append(np.array(ids))
            migrate(ids)

        qs.on_touched = hook

        def refuse(*args):
            raise AssertionError("the map is not used with on_touched")

        monkeypatch.setattr(qs._touched, "record", refuse)
        tokens = sys_.tokens.create_batch(base[rng.integers(0, N, QB)], K)
        qs.search_batch(tokens)
        assert _root_counters() == {} and len(seen) == 1
        assert sys_.tracker.unique_count() == 0     # the hook drained it
        parts = []
        monkeypatch.setattr(qs._touched, "record",
                            lambda p, tracker, rows: parts.append(p) or True)
        qs.on_touched = None
        qs.search_batch(tokens)
        np.testing.assert_array_equal(seen[0], _whole(parts[0]))
    finally:
        sys_.shutdown()


# -- what the service keeps ----------------------------------------------------


def test_service_retains_each_id_once_over_200_batches(tmp_path, data):
    """200 batches of the same tokens: the tracker retains no more ids than
    the distinct ids touched."""
    base, rng = data
    sys_ = _system(tmp_path / "db", base)
    try:
        tokens = sys_.tokens.create_batch(base[rng.integers(0, N, QB)], K)
        sys_.query_service.search_batches([tokens] * 200)
        retained = sum(len(p) for p in sys_.tracker._parts)
        assert retained == sys_.tracker.unique_count() > 0
    finally:
        sys_.shutdown()


def test_counters_read_back_through_recent(tmp_path, data):
    """``query.track.ids`` counts the ids the map examined, every id a
    query decrypted; ``query.track.fresh`` those it forwarded: all of them
    on the first batch, none when the same batch repeats."""
    base, rng = data
    sys_ = _system(tmp_path / "db", base)
    try:
        tokens = sys_.tokens.create_batch(base[rng.integers(0, N, QB)], K)
        qs = sys_.query_service
        res = qs.search_batch(tokens)
        assert not any(s.retried for s in res.stats)
        first = _root_counters()
        decrypted = sum(s.cand_decrypted for s in res.stats)
        assert first["query.track.ids"] == decrypted > 0
        (forwarded,) = sys_.tracker._parts      # read without compacting
        assert first["query.track.fresh"] == len(np.unique(forwarded)) \
            == len(forwarded)
        qs.search_batches([tokens, tokens])
        assert _root_counters() == {"query.track.ids": 2 * decrypted,
                                    "query.track.fresh": 0}
    finally:
        sys_.shutdown()


def test_new_tracker_clears_the_map():
    """A service given another tracker forwards every id to it."""
    touched = TouchedMap()
    a, b = ReencryptionTracker(), ReencryptionTracker()
    ids = np.array([3, 9, 9, 27])
    touched.record([ids], a, 100)
    touched.record([ids], b, 100)
    assert a.drain() == b.drain() == [3, 9, 27]


@pytest.mark.parametrize("bad", ["negative", "past_cap"])
def test_map_declines_ids_it_cannot_hold(bad):
    touched, tracker = TouchedMap(), ReencryptionTracker()
    ids = np.array([-1, 5]) if bad == "negative" else np.array([0, 400])
    assert touched.record([ids], tracker, 100) is False
    assert tracker.drain() == []


class DrainedDuringRecord(ReencryptionTracker):
    """A tracker drained by another thread just before the map's record
    lands (the facades drain from whichever thread calls them)."""

    def __init__(self):
        super().__init__()
        self.armed, self.drained = False, []

    def record(self, ids):
        if self.armed:
            self.armed = False
            self.drained.append(self.drain())
        super().record(ids)


def test_drain_during_a_batch_keeps_the_batch_whole():
    """A drain that lands while a batch is being marked takes the ids
    marked before it; the batch then goes to the tracker whole, as a
    whole-batch record after that drain would have put it, and the next
    batch finds the map cleared."""
    touched, tracker = TouchedMap(), DrainedDuringRecord()
    touched.record([np.array([1, 2, 3])], tracker, 100)
    tracker.armed = True
    touched.record([np.array([2, 3, 4])], tracker, 100)
    touched.record([np.array([1])], tracker, 100)     # drained above
    assert tracker.drained == [[1, 2, 3]]
    assert tracker.drain() == [1, 2, 3, 4]
