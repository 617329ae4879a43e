"""The port's span recorder (``fspann_tpu_torch/utils/profiler.py``) and the
spans placed at the layer boundaries of the serving and insert paths, on
the CPU at a small size: nesting, self time, the bounded root history, no
profiler range and no CUDA event while no ``torch.profiler`` records, the
``fspann.*`` ranges on the profiler's clock when one does, the per-query
``SearchStats`` fields filled from the spans, the insert path's split and
the ``python.gc`` span."""

import gc
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.utils import profiler

N, D, QB = 900, 16, 8
INSERT = ("index.append.check", "index.append.encode", "index.append.device",
          "index.append.host_copy", "store.seal", "store.persist")


@pytest.fixture(autouse=True)
def _fresh():
    profiler.reset()
    yield
    profiler.reset()


def _cfg(**rt):
    kw = dict(refinement_limit=400, max_global_candidates=400, block_size=32,
              routing_mode="scan", rerank_limit=100, encode_backend="cpu",
              scan_native="off", scan_capacity_rows=0)
    kw.update(rt)
    return tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3,
                                  seed=13),
        runtime=tconfig.RuntimeConfig(**kw),
        eval=tconfig.EvalConfig(k_variants=(1, 10))).validate()


def _system(tmp_path, **rt):
    rng = np.random.default_rng(7)
    base = rng.normal(size=(N, D)).astype(np.float32)
    sys_ = ForwardSecureANNSystem(_cfg(**rt), str(tmp_path / "db"), D,
                                  query_batch=QB, device="cpu")
    sys_.index_stream(base, batch_size=300)
    sys_.finalize_for_search()
    queries = base[rng.integers(0, N, 3 * QB)] + 0.01
    profiler.reset()
    return sys_, queries


def _batches(sys_, queries, k=10):
    return [sys_.tokens.create_batch(queries[s:s + QB], k)
            for s in range(0, len(queries), QB)]


# -- the recorder ------------------------------------------------------------


def test_nesting_self_time_and_root_record():
    with profiler.span("outer") as outer:
        with profiler.span("inner") as inner:
            time.sleep(0.01)
            profiler.count("things", 3)
        with profiler.span("inner"):
            pass
        time.sleep(0.005)
    spans = profiler.totals()["spans"]
    n_outer, total_outer, self_outer = spans["outer"]
    n_inner, total_inner, self_inner = spans["inner"]
    assert (n_outer, n_inner) == (1, 2)
    assert total_outer == outer.ns and inner.ns >= 10_000_000
    assert outer.children == {"inner": total_inner}
    assert self_outer == total_outer - total_inner >= 5_000_000
    assert self_inner == total_inner                     # a leaf
    assert profiler.totals()["counters"] == {"things": 3}
    (root,) = profiler.recent("outer", 1)
    assert root == {"outer": total_outer, "inner": total_inner, "things": 3}
    assert profiler.recent("inner", 1) == []             # never a root


def test_roots_are_numbered_and_the_history_is_bounded():
    bound = profiler.SPAN_HISTORY
    for i in range(bound + 5):
        with profiler.span("req"):
            profiler.count("i", i)
    hist = profiler.recent("req", bound + 5)
    assert len(hist) == bound
    assert [h["i"] for h in hist[:2]] == [5, 6]
    assert [h["i"] for h in profiler.recent("req", 3)] == \
        [bound + 2, bound + 3, bound + 4]
    assert profiler.recent("req", 0) == []
    assert profiler.totals()["spans"]["req"][0] == bound + 5
    profiler.reset()
    assert profiler.recent("req", 1) == [] and profiler.totals() == {
        "spans": {}, "counters": {}}


def test_spans_of_another_thread_are_their_own_roots():
    import threading

    with profiler.span("main"):
        t = threading.Thread(target=lambda: profiler.span("worker")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    assert len(profiler.recent("worker", 1)) == 1
    assert profiler.recent("main", 1)[0].keys() == {"main"}


def test_threads_lose_no_update():
    """Many threads record into the shared totals at once: every span and
    count arrives."""
    import os
    import sys
    import threading

    workers = 4 * (os.cpu_count() or 2)
    each = profiler.SPAN_HISTORY // workers      # every root stays recent

    def work():
        for _ in range(each):
            with profiler.span("req"):
                with profiler.span("part"):
                    profiler.count("n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tot = profiler.totals()
    assert tot["spans"]["req"][0] == tot["spans"]["part"][0] == \
        workers * each
    assert tot["counters"]["n"] == workers * each
    assert len(profiler.recent("req", workers * each)) == workers * each
    assert all(r.keys() >= {"req", "part", "n"}
               for r in profiler.recent("req", 100))


def test_a_collection_is_a_python_gc_span():
    with profiler.span("work"):
        gc.collect()
    spans = profiler.totals()["spans"]
    assert spans["python.gc"][0] >= 1
    assert profiler.totals()["counters"].get("python.gc.gen2", 0) >= 1
    assert "python.gc" in profiler.recent("work", 1)[0]


# -- profiler off and on ------------------------------------------------------


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1

    def record(self, stream=None):
        pass

    def elapsed_time(self, other):
        return 1.0                      # ms


class _CudaFacing:
    """The index as the query service sees it, with a CUDA device: the
    service's events go to the card's stream (faked here), the route runs
    on the CPU index behind it."""

    def __init__(self, index):
        self._index = index
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._index, name)


def _cuda_facing(sys_, monkeypatch):
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    sys_.query_service.index = _CudaFacing(sys_.index)


def test_profiler_off_enters_no_range_and_records_no_event(tmp_path,
                                                           monkeypatch):
    sys_, queries = _system(tmp_path)
    _cuda_facing(sys_, monkeypatch)

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    res = sys_.query_service.search_batches(_batches(sys_, queries))
    sys_.search(sys_.create_token(queries[0] + 0.5, 10))
    sys_.insert_live(np.arange(N, N + 4), queries[:4])
    gc.collect()
    assert _FakeEvent.made == 0
    assert all(s.stage_a_device_ns is None for r in res for s in r.stats)
    spans = profiler.totals()["spans"]
    assert spans["query.search_batches"][0] == 2      # the batches, search
    assert spans["system.search"][0] == spans["system.insert_live"][0] == 1


def test_profiler_on_puts_spans_on_its_clock(tmp_path, monkeypatch):
    sys_, queries = _system(tmp_path)
    _cuda_facing(sys_, monkeypatch)
    batches = _batches(sys_, queries)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = sys_.query_service.search_batches(batches)
    assert _FakeEvent.made == 2 * len(batches)
    for r in res:
        for s in r.stats:
            assert s.stage_a_device_ns == 1_000_000 // QB
    events = [e for e in prof.events() if e.name.startswith("fspann.")]
    names = {e.name for e in events}
    assert {"fspann.query.search_batches", "fspann.query.token_open",
            "fspann.query.dispatch", "fspann.query.wait",
            "fspann.query.decrypt", "fspann.query.refine",
            "fspann.query.track", "fspann.store.lookup",
            "fspann.store.open", "fspann.index.scan"} <= names
    (outer,) = [e for e in events if e.name == "fspann.query.search_batches"]
    inner = [e for e in events if e.name.startswith(
        ("fspann.query.", "fspann.store.")) and e is not outer]
    assert len(inner) >= 7 * len(batches)
    for e in inner:
        assert outer.time_range.start <= e.time_range.start \
            <= e.time_range.end <= outer.time_range.end, e.name


# -- the serving path's fields ------------------------------------------------


@pytest.mark.parametrize("refine", ["host", "device"])
def test_search_stats_split_the_route_and_the_decrypt(tmp_path, refine):
    sys_, queries = _system(tmp_path, refine_backend=refine)
    res = sys_.query_service.search_batches(_batches(sys_, queries))
    stats = [s for r in res for s in r.stats]
    assert len(stats) == len(queries)
    for s in stats:
        assert s.route_ns == s.dispatch_ns + s.wait_ns
        assert s.decrypt_ns >= s.lookup_ns + s.open_ns
        assert s.open_ns > 0 and s.lookup_ns > 0 and s.token_open_ns > 0
        assert s.track_ns > 0 and s.stage_a_device_ns is None
        assert (s.upload_ns > 0) == (refine == "device")
    spans = profiler.totals()["spans"]
    assert spans["query.dispatch"][0] == spans["query.wait"][0] == len(res)
    if refine == "device":
        for name in ("refine.upload", "refine.compute", "refine.download"):
            assert spans[name][0] == len(res)
    (root,) = profiler.recent("query.search_batches", 1)
    assert root["query.decrypt"] >= root["store.open"] > 0


def test_token_roots(tmp_path):
    sys_, queries = _system(tmp_path)
    _batches(sys_, queries)
    sys_.create_token(queries[0], 10)
    roots = profiler.recent("token.create", 4)
    assert len(roots) == 4
    for r in roots:
        assert r.keys() == {"token.create", "token.encode", "token.seal"}
        assert r["token.create"] >= r["token.encode"] + r["token.seal"]


def test_facade_search_is_a_root(tmp_path):
    sys_, queries = _system(tmp_path)
    tok = sys_.create_token(queries[0], 10)
    sys_.search(tok)
    sys_.search(tok)                    # the query cache's hit
    first, hit = profiler.recent("system.search", 2)
    assert first["query.search_batches"] > 0 and "query.decrypt" in first
    assert hit.keys() == {"system.search"}


def test_retried_query_charges_both_passes(tmp_path, monkeypatch):
    from fspann_tpu_torch.query import service

    sys_, queries = _system(tmp_path)
    svc = sys_.query_service
    calls = []
    need = service.QueryService._need_retry

    def once(self, s, k):
        calls.append(1)
        return len(calls) == 1 or need(self, s, k)

    monkeypatch.setattr(service.QueryService, "_need_retry", once)
    res = svc.search_batch(sys_.tokens.create_batch(queries[:QB], 10))
    s = res.stats[0]
    assert s.retried
    spans = profiler.totals()["spans"]
    assert spans["query.retry"][0] == 1 and spans["query.dispatch"][0] == 2
    # its first pass's share of the batch, and its share of the retry
    root = profiler.recent("query.search_batches", 1)[0]
    assert s.dispatch_ns >= root["query.dispatch"] // QB - 1
    assert s.route_ns == s.dispatch_ns + s.wait_ns
    assert s.decrypt_ns >= s.lookup_ns + s.open_ns


# -- the insert path ------------------------------------------------------------


def test_insert_live_splits_into_its_six_phases(tmp_path):
    sys_, queries = _system(tmp_path)
    sys_.insert_live(np.arange(N, N + 16), queries[:16] + 0.25)
    (root,) = profiler.recent("system.insert_live", 1)
    for name in INSERT:
        assert root.get(name, 0) > 0, name
    assert root["system.insert_live"] >= sum(root[n] for n in INSERT)
    bits = sys_.cfg.paper.num_groups * sys_.cfg.paper.code_bits
    assert root["index.append.grow_bytes"] == (N + 16) * (bits + 4)
    # the next route rebuilds the tombstones
    sys_.query_service.search_batch(sys_.tokens.create_batch(queries[:QB],
                                                             10))
    assert profiler.totals()["spans"]["index.tombstones"][0] >= 1
