"""The reader of the probe re-rank's gather share
(``metrics/rerank_gather_share.batch``: counter
``code_hamming.gather_slots`` over ``code_hamming.slots``), on synthetic
roots and on the CPU at a test size, and nothing from a program that keeps
no such counters.  On the card ``deep10m-probe.b64`` gathers every slot
(64 x 49,152 slots a batch over 10M rows) and ``sift1m-probe.b64`` sweeps
every one (over 1M rows); on the CPU ``code_hamming`` runs its plain
version, a gather, so a traced run there reads 1.0."""

import json
import os
import time
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

NAME = "rerank_gather_share.batch"
CELLS = ["sift1m-probe.b64", "deep10m-probe.b64"]


def _reader():
    return harness._module(os.path.join(ROOT, "bench_torch", "metrics",
                                        f"{NAME}.py")).read


def _run(kind, queries, batch=64, calls=16):
    return types.SimpleNamespace(
        kind=kind, queries=queries,
        cell=types.SimpleNamespace(traffic={"batch": batch, "calls": calls}))


def test_the_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        (entry,) = [m for m in json.load(f)["per_layer"]
                    if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "fraction", "better": "higher",
                     "source": "program_counter",
                     "layer": "probe re-rank kernel", "moves": "qps",
                     "workloads": CELLS}


def test_share_over_the_windows_roots(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    roots = [{"query.search_batches": 1, "code_hamming.slots": s,
              "code_hamming.gather_slots": g}
             for s, g in ((3_145_728, 3_145_728), (3_145_728, 0),
                          (6_291_456, 6_291_456))]
    asked = []

    def recent(root, n):
        asked.append((root, n))
        return roots[-n:]

    monkeypatch.setattr(profiler, "recent", recent)
    assert _reader()(_run("batch", 3 * 16 * 64)) == pytest.approx(0.75)
    assert asked == [("query.search_batches", 3)]
    assert _reader()(_run("single", 64, batch=1, calls=64)) is None
    assert _reader()(_run("batch", 0)) is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "recent", lambda root, n: [
        {"query.search_batches": 1, "index.route": 5}] * n)
    assert _reader()(_run("batch", 2 * 16 * 64)) is None
    monkeypatch.delattr(profiler, "recent")
    assert _reader()(_run("batch", 2 * 16 * 64)) is None


def test_reads_the_plain_gather_in_a_traced_cpu_run(monkeypatch):
    got = {}
    original = harness._read_metrics

    def read_all(run, specs):
        got["v"] = _reader()(run)
        return original(run, specs)

    monkeypatch.setattr(harness, "_read_metrics", read_all)
    t = time.perf_counter()
    res = harness.run_cell(ROOT, "deep10m-probe.b64", 2 ** 31 + 59, 0.01,
                           True, "cpu", t, t,
                           overrides={"n": 8192, "n_clusters": 64},
                           traffic_overrides={"calls": 1})
    assert res["correct"], res["checks"]
    assert got["v"] == 1.0
    assert res["metrics"][NAME]["value"] == 1.0
