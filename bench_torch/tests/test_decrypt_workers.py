"""The reader of ``decrypt_workers.batch`` (``metrics/decrypt_workers.batch.py``,
counter ``store.open.workers``): the threads that took a share of each
batch's candidate read, per batch, in the batched cells its entry lists;
nothing in a single-query cell, and nothing from a program that keeps no
such counter."""

import json
import os
import time
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

NAME = "decrypt_workers.batch"
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _reader():
    return harness._module(os.path.join(ROOT, "bench_torch", "metrics",
                                        f"{NAME}.py")).read


def _run(kind, queries, batch=64, calls=16):
    return types.SimpleNamespace(
        kind=kind, queries=queries,
        cell=types.SimpleNamespace(traffic={"batch": batch, "calls": calls}))


def test_the_entry_lists_the_batched_cells():
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert entry["workloads"] == ["sift1m-scan.b64", "sift1m-probe.b64",
                                  "sift1m-scan.ycsb-d"]
    assert entry["source"] == "program_counter" and entry["moves"] == "qps"


def test_mean_per_batch_over_the_windows_roots(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    roots = [{"query.search_batches": 1, "store.open.workers": w}
             for w in (96, 128, 112)]
    asked = []

    def recent(root, n):
        asked.append((root, n))
        return roots[-n:]

    monkeypatch.setattr(profiler, "recent", recent)
    # three roots of 16 batches of 64 queries
    assert _reader()(_run("batch", 3 * 16 * 64)) == pytest.approx(7.0)
    assert asked == [("query.search_batches", 3)]
    assert _reader()(_run("single", 64, batch=1, calls=64)) is None


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "recent", lambda root, n: [
        {"query.search_batches": 1, "store.open": 5}] * n)
    assert _reader()(_run("batch", 2 * 16 * 64)) is None
    monkeypatch.delattr(profiler, "recent")
    assert _reader()(_run("batch", 2 * 16 * 64)) is None


@pytest.mark.parametrize("cell,reads", [("sift1m-scan.b64", True),
                                        ("sift1m-scan.b1", False)])
def test_reads_in_a_traced_cpu_run(monkeypatch, cell, reads):
    """A traced run of the cell at a test size: the reader finds the
    program's counter in a batched cell (at least the calling thread took
    each batch), and nothing in a single-query one."""
    got = {}
    original = harness._read_metrics

    def read_all(run, specs):
        got["v"] = _reader()(run)
        return original(run, specs)

    monkeypatch.setattr(harness, "_read_metrics", read_all)
    t = time.perf_counter()
    res = harness.run_cell(ROOT, cell, 2 ** 31 + 23, 0.5, True, "cpu", t, t,
                           overrides={"n": 3000})
    assert res["correct"], res["checks"]
    if reads:
        assert isinstance(got["v"], float) and got["v"] >= 1.0
        assert res["metrics"][NAME]["value"] == got["v"]
    else:
        assert got["v"] is None and NAME not in res["metrics"]
