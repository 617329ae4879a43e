"""The reader of the scan's packed share (``metrics/scan_packed_share.batch``:
counter ``scan.packed_rows`` over ``scan.rows``), on the CPU at a test size:
1.0 where the cell serves its codes packed (``deep10m-scan.b64``), 0.0 where
it serves the unpacked bits (``sift1m-scan.b64``), and nothing from a
program that keeps no such counters.  Both cells run with the native host
scan off, so that the device scan serves on the CPU as it does on the
card."""

import json
import os
import time
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

NAME = "scan_packed_share.batch"
CELLS = {"deep10m-scan.b64": ({"n": 8192, "n_clusters": 64}, 1.0),
         "sift1m-scan.b64": ({"n": 3000}, 0.0)}


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
                     "layer": "scan stage A on the card", "moves": "qps",
                     "workloads": list(CELLS)}


def test_share_over_the_windows_roots(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    roots = [{"query.search_batches": 1, "scan.rows": r, "scan.packed_rows": p}
             for r, p in ((1_000, 1_000), (2_000, 0), (1_000, 1_000))]
    asked = []

    def recent(root, n):
        asked.append((root, n))
        return roots[-n:]

    monkeypatch.setattr(profiler, "recent", recent)
    assert _reader()(_run("batch", 3 * 16 * 64)) == pytest.approx(0.5)
    assert asked == [("query.search_batches", 3)]
    assert _reader()(_run("single", 64, batch=1, calls=64)) is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "recent", lambda root, n: [
        {"query.search_batches": 1, "index.scan": 5}] * n)
    assert _reader()(_run("batch", 2 * 16 * 64)) is None
    monkeypatch.delattr(profiler, "recent")
    assert _reader()(_run("batch", 2 * 16 * 64)) is None


@pytest.mark.parametrize("cell", list(CELLS))
def test_reads_its_share_in_a_traced_run(monkeypatch, cell):
    overrides, want = CELLS[cell]
    find = harness.Cell.find

    def device_scan(root, workload):
        found = find(root, workload)
        found.config["program"]["runtime"]["scan_native"] = "off"
        return found

    monkeypatch.setattr(harness.Cell, "find", staticmethod(device_scan))
    got = {}
    original = harness._read_metrics

    def read_all(run, specs):
        got["v"] = _reader()(run)
        return original(run, specs)

    monkeypatch.setattr(harness, "_read_metrics", read_all)
    t = time.perf_counter()
    res = harness.run_cell(ROOT, cell, 2 ** 31 + 53, 0.01, True, "cpu", t, t,
                           overrides=overrides,
                           traffic_overrides={"calls": 1})
    assert res["correct"], res["checks"]
    assert got["v"] == want
    assert res["metrics"][NAME]["value"] == want
