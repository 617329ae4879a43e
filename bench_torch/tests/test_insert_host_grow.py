"""The reader of the live insert's host regrowth
(``metrics/insert_host_grow_mib_per_call.ingest``: counter
``index.append.host_grow_bytes`` under each ``system.insert_live`` root),
on the CPU at a test size: it reads a number in the cell its entry lists
and nothing elsewhere, and nothing from a program that keeps no such
counter."""

import json
import os
import time
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

NAME = "insert_host_grow_mib_per_call.ingest"
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = {"sift1m-scan.b64": 0.5, "sift1m-scan.b1": 0.5,
         "sift1m-scan.ycsb-d": 1.0}


def _read(run):
    return harness._module(os.path.join(ROOT, "bench_torch", "metrics",
                                        f"{NAME}.py")).read(run)


def test_the_entry():
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "MiB", "better": "lower",
                     "source": "program_counter", "layer": "live insert",
                     "moves": "insert_rows_per_s",
                     "workloads": ["sift1m-scan.ycsb-d"]}


@pytest.fixture(scope="module")
def readings():
    """{cell: (value, result)} of the reader, read in each cell's traced
    run while its program is the last to have run."""
    out = {}
    original = harness._read_metrics

    def read_all(run, specs):
        out[run.cell.name] = _read(run)
        return original(run, specs)

    harness._read_metrics = read_all
    try:
        for cell, seconds in CELLS.items():
            t = time.perf_counter()
            res = harness.run_cell(ROOT, cell, 2 ** 31 + 13, seconds, True,
                                   "cpu", t, t, overrides={"n": 3000})
            assert res["correct"], (cell, res["checks"])
            out[cell] = (out[cell], res["metrics"])
    finally:
        harness._read_metrics = original
    return out


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reads_in_its_cell_and_nowhere_else(readings, cell):
    value, metrics = readings[cell]
    if cell == "sift1m-scan.ycsb-d":
        # the warm-up's insert took the regrowth; the window's write into
        # the spare rows it reserved
        assert value == 0.0 and metrics[NAME]["value"] == 0.0
    else:
        assert value is None and NAME not in metrics, (cell, value)


@pytest.mark.parametrize("roots,want", [
    ([{"index.append.host_copy": 5}] * 2, None),
    ([{"index.append.host_grow_bytes": 3 << 20},
      {"index.append.host_grow_bytes": 0}], 1.5)])
def test_reads_only_a_program_that_counts_it(monkeypatch, roots, want):
    """The mean over the window's inserts where their records carry the
    counter, and nothing where they do not (a program from before it)."""
    from fspann_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "recent", lambda root, n: roots[-n:])
    assert _read(types.SimpleNamespace(insert_ms=[1.0, 2.0])) == want


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "recent")
    assert _read(types.SimpleNamespace(insert_ms=[1.0, 2.0])) is None
