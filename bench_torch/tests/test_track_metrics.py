"""The readers of the query service's touched-set tracking
(``metrics/track_ms_per_q.*``: ``SearchStats.track_ns``, the
``query.track`` span; ``metrics/track_fresh_share.batch``: counters
``query.track.fresh`` over ``query.track.ids``), on the CPU at a test
size: each reads a number in every cell its entry lists and nothing
elsewhere, and the share reads nothing from a program that keeps no such
counters."""

import json
import os
import time
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

BATCH, SINGLE, SHARE = ("track_ms_per_q.batch", "track_ms_per_q.single",
                        "track_fresh_share.batch")
NAMES = (BATCH, SINGLE, SHARE)
LAYER = "query service: touched-set tracking"
BATCHED = ["sift1m-scan.b64", "sift1m-probe.b64", "sift1m-scan.ycsb-d",
           "gist1m-scan.b64"]
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = {"sift1m-scan.b64": (0.5, None), "sift1m-scan.b1": (0.5, None),
         "sift1m-scan.ycsb-d": (1.0, None),
         # the probe route's plain twins take seconds a batch on the CPU
         "sift1m-probe.b64": (0.01, {"calls": 1})}


def _reader(name):
    return harness._module(os.path.join(ROOT, "bench_torch", "metrics",
                                        f"{name}.py")).read


def _run(kind, queries, batch=64, calls=16):
    return types.SimpleNamespace(
        kind=kind, queries=queries,
        cell=types.SimpleNamespace(traffic={"batch": batch, "calls": calls}))


@pytest.mark.parametrize("name,unit,source,moves,cells", [
    (BATCH, "ms", "program_span", "qps", BATCHED),
    (SINGLE, "ms", "program_span", "query_p95_ms", ["sift1m-scan.b1"]),
    (SHARE, "fraction", "program_counter", "qps", BATCHED)])
def test_the_entries(name, unit, source, moves, cells):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry == {"name": name, "unit": unit, "better": "lower",
                     "source": source, "layer": LAYER, "moves": moves,
                     "workloads": cells}


def test_share_over_the_windows_roots(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    roots = [{"query.search_batches": 1, "query.track.ids": i,
              "query.track.fresh": f}
             for i, f in ((1_000, 300), (2_000, 100), (1_000, 0))]
    asked = []

    def recent(root, n):
        asked.append((root, n))
        return roots[-n:]

    monkeypatch.setattr(profiler, "recent", recent)
    # three calls of 16 batches of 64 queries
    assert _reader(SHARE)(_run("batch", 3 * 16 * 64)) == pytest.approx(0.1)
    assert asked == [("query.search_batches", 3)]
    assert _reader(SHARE)(_run("single", 64, batch=1, calls=64)) is None


def test_a_program_without_the_counters_reads_no_share(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "recent", lambda root, n: [
        {"query.search_batches": 1, "query.track": 5}] * n)
    assert _reader(SHARE)(_run("batch", 2 * 16 * 64)) is None
    monkeypatch.delattr(profiler, "recent")
    assert _reader(SHARE)(_run("batch", 2 * 16 * 64)) is None


def test_times_read_their_kind_only():
    stats = [types.SimpleNamespace(track_ns=ns) for ns in (1_000, 3_000)]
    for name, kind in ((BATCH, "batch"), (SINGLE, "single")):
        run = types.SimpleNamespace(kind=kind, stats=stats)
        assert _reader(name)(run) == pytest.approx(0.002)
        run.kind = "single" if kind == "batch" else "batch"
        assert _reader(name)(run) is None


@pytest.fixture(scope="module")
def readings():
    """{cell: ({metric: value}, result)} of the three readers, read in
    each cell's traced run while its program is the last to have run."""
    out = {}
    original = harness._read_metrics

    def read_all(run, specs):
        out[run.cell.name] = {n: _reader(n)(run) for n in NAMES}
        return original(run, specs)

    harness._read_metrics = read_all
    try:
        for cell, (seconds, mix) in CELLS.items():
            t = time.perf_counter()
            res = harness.run_cell(ROOT, cell, 2 ** 31 + 37, seconds, True,
                                   "cpu", t, t, overrides={"n": 3000},
                                   traffic_overrides=mix)
            assert res["correct"], (cell, res["checks"])
            out[cell] = (out[cell], res["metrics"])
    finally:
        harness._read_metrics = original
    return out


@pytest.mark.parametrize("name", NAMES)
def test_reads_in_its_cells_and_nowhere_else(readings, name):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    for cell, (values, metrics) in readings.items():
        v = values[name]
        if cell in entry["workloads"]:
            assert isinstance(v, float) and v > 0, (cell, v)
            assert metrics[name]["value"] == v
            if name == SHARE:
                assert v <= 1.0
        else:
            assert v is None and name not in metrics, (cell, v)


def test_share_falls_as_the_map_fills(monkeypatch):
    """A longer batched run on the same 3,000 rows: the later batches find
    their ids marked, so the share over the window is well under 1."""
    got = {}
    original = harness._read_metrics

    def read_all(run, specs):
        got["v"] = _reader(SHARE)(run)
        return original(run, specs)

    monkeypatch.setattr(harness, "_read_metrics", read_all)
    t = time.perf_counter()
    res = harness.run_cell(ROOT, "sift1m-scan.b64", 2 ** 31 + 41, 1.5, True,
                           "cpu", t, t, overrides={"n": 3000})
    assert res["correct"], res["checks"]
    assert 0 < got["v"] < 0.5
