"""The benchmark's ``deep10m-scan.b64`` cell on the CPU at a small size.

The cell keeps its whole shape (d 96, m 64 over 8 tables x 3 divisions, so
3,072-bit codes, L 2,000, margin 40, 10M rows in the configuration's file)
and runs here over 8,192 seeded rows in 64 clusters (the generator's
default for that many rows; the file's 10,000 clusters need at least as
many rows): a sound run reads correct against the plain ``l2_exact``
reference, and the control (the program's int8 storage, the precision
below the configuration's f16) reads not correct by ``dist_err``.  The
codes are served packed, as on the card: here the native host scan that
``scan_native="auto"`` picks on the CPU is turned off, so that the packed
state is built and the chunked scan serves."""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_torch import harness  # noqa: E402

CELL = "deep10m-scan.b64"
SMALL = {"n": 8192, "n_clusters": 64}
# one batch of 64 a cycle, one cycle in the window
MIX = {"calls": 1}


def _packed_on_the_cpu(monkeypatch):
    """The cell as found, with the host scan off: the card's layout."""
    find = harness.Cell.find

    def packed(root, workload):
        cell = find(root, workload)
        cell.config["program"]["runtime"]["scan_native"] = "off"
        return cell

    monkeypatch.setattr(harness.Cell, "find", staticmethod(packed))


def _run(monkeypatch, control=False):
    _packed_on_the_cpu(monkeypatch)
    t = time.perf_counter()
    return harness.run_cell(ROOT, CELL, 2 ** 31 + 77, 0.01, False, "cpu", t,
                            t, control=control, overrides=SMALL,
                            traffic_overrides=MIX)


def test_the_cell_keeps_the_deep_shape():
    cell = harness.Cell.find(ROOT, CELL)
    corpus, program = cell.config["corpus"], cell.config["program"]
    assert (corpus["n"], corpus["d"], corpus["d_eff"],
            corpus["n_clusters"]) == (10_000_000, 96, 24, 10_000)
    cfg = harness.system_config(program)
    assert cfg.paper.m == 64 and cfg.paper.num_groups == 24
    assert cfg.paper.num_groups * cfg.paper.code_bits == 3072
    rt = cfg.runtime
    assert (rt.rerank_limit, rt.adaptive_decrypt_margin) == (2000, 40)
    assert (rt.routing_mode, rt.storage_dtype, rt.encode_backend,
            rt.scan_capacity_rows, rt.scan_packed) == ("scan", "f16", "cpu",
                                                       0, "on")
    # the set-up is built on every host core, and the file says so
    assert program["runtime"]["setup_threads"] == rt.setup_threads == 0
    assert (program["query_batch"], program["ingest_batch"]) == (64,
                                                                100_000)
    assert cell.traffic["requests"] == "batch" and cell.chips == 1
    assert cell.config["reference"] == "l2_exact"
    assert cell.config["control"] == {"runtime": {"storage_dtype": "i8"}}
    assert cell.config["limits"] == {"dist_err": {"max": 5e-4},
                                     "recall10": {"min": 0.98},
                                     "ratio100": {"max": 1.01}}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        (entry,) = [c for c in json.load(f)["configs"]
                    if c["name"] == "deep10m-scan"]
    assert entry["reduced"] == []


def test_sound_run_is_correct(monkeypatch, capsys):
    out = _run(monkeypatch)
    # the set-up line names the layout built: the packed words
    assert "'scan_upload_packed'" in capsys.readouterr().err
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["recall10"]["value"] >= 0.98


def test_control_fails_by_dist_err(monkeypatch):
    out = _run(monkeypatch, control=True)
    assert not out["correct"]
    c = out["checks"]["dist_err"]
    assert c["value"] > float(c["limit"].split()[-1])
