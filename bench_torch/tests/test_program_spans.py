"""The readers of the program's own spans (``bench_torch/program_spans.py``
and the metrics that call it), on the CPU at a test size: each reads a
number in every cell its entry in ``BENCHMARK.json`` lists and nothing
elsewhere, and each reads nothing from a program that keeps no spans."""

import json
import os
import time
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

SMALL = {"n": 3000}
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = ["unspanned_ms_per_q.batch", "token_ms_per_q.batch",
       "route_dispatch_ms_per_q.batch", "stage_a_device_ms_per_q.batch",
       "decrypt_open_ms_per_q.batch", "unspanned_ms_per_q.single",
       "token_ms_per_q.single", "route_dispatch_ms_per_q.single",
       "stage_a_device_ms_per_q.single", "decrypt_open_ms_per_q.single",
       "decrypt_lookup_ms_per_q.batch", "refine_upload_ms_per_q.batch",
       "insert_check_ms_per_call.ingest", "insert_encode_ms_per_call.ingest",
       "insert_device_ms_per_call.ingest",
       "insert_host_copy_ms_per_call.ingest",
       "insert_seal_ms_per_call.ingest", "insert_persist_ms_per_call.ingest",
       "insert_grow_gib_per_call.ingest"]
# stage A's CUDA events exist only on the card
CARD_ONLY = {"stage_a_device_ms_per_q.batch", "stage_a_device_ms_per_q.single"}
CELLS = {"sift1m-scan.b64": (0.5, None), "sift1m-scan.b1": (0.5, None),
         "sift1m-scan.ycsb-d": (1.0, None),
         # the probe route's plain twins take seconds a batch on the CPU
         "sift1m-probe.b64": (0.01, {"calls": 1})}


def _reader(name):
    return harness._module(os.path.join(ROOT, "bench_torch", "metrics",
                                        f"{name}.py")).read


@pytest.fixture(scope="module")
def readings():
    """{cell: {metric: value}} of every new reader, read in each cell's
    traced run while its program is the last one to have run."""
    out = {}
    original = harness._read_metrics

    def read_all(run, specs):
        out[run.cell.name] = {n: _reader(n)(run) for n in NEW}
        return original(run, specs)

    harness._read_metrics = read_all
    try:
        for cell, (seconds, mix) in CELLS.items():
            t = time.perf_counter()
            res = harness.run_cell(ROOT, cell, 2 ** 31 + 11, seconds, True,
                                   "cpu", t, t, overrides=SMALL,
                                   traffic_overrides=mix)
            assert res["correct"], (cell, res["checks"])
    finally:
        harness._read_metrics = original
    return out


def test_every_new_metric_has_an_entry_and_a_file():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        assert name in entries, name
        assert callable(_reader(name)), name


@pytest.mark.parametrize("name", NEW)
def test_reads_in_its_cells_and_nowhere_else(readings, name):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    for cell, values in readings.items():
        v = values[name]
        if cell in entry["workloads"] and name not in CARD_ONLY:
            assert isinstance(v, float) and v >= 0, (cell, v)
        else:
            assert v is None, (cell, v)


def test_insert_phases_on_the_cpu(readings):
    """On the CPU the native host scan serves from the host code array: the
    array grows, no device state does."""
    got = readings["sift1m-scan.ycsb-d"]
    assert got["insert_host_copy_ms_per_call.ingest"] > 0
    assert got["insert_seal_ms_per_call.ingest"] > 0
    assert got["insert_device_ms_per_call.ingest"] == 0
    assert got["insert_grow_gib_per_call.ingest"] == 0


def test_stage_a_device_time_reads_the_stats_that_carry_it():
    stats = [types.SimpleNamespace(stage_a_device_ns=v)
             for v in (None, 2_000_000, 4_000_000)]
    for kind in ("batch", "single"):
        run = types.SimpleNamespace(kind=kind, stats=stats)
        assert _reader(f"stage_a_device_ms_per_q.{kind}")(run) == 3.0
        other = "single" if kind == "batch" else "batch"
        assert _reader(f"stage_a_device_ms_per_q.{other}")(run) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A program that lacks the recorder and the fields (the parent of the
    change that brought them) reads as nothing, and nothing raises."""
    from fspann_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "recent")
    old = types.SimpleNamespace(server_ns=10, route_ns=1, decrypt_ns=2,
                                refine_ns=3)
    traffic = {"batch": 64, "insert_rows": 64}
    for kind in ("batch", "single"):
        run = types.SimpleNamespace(
            kind=kind, stats=[old], queries=128, insert_ms=[1.0, 2.0],
            cell=types.SimpleNamespace(traffic=traffic),
            program={"runtime": {"refine_backend": "device"}})
        for name in NEW:
            assert _reader(name)(run) is None, name
