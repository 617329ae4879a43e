"""The readers of ``decrypt_mb_per_q.batch`` and ``decrypt_open_gbps.batch``
(``metrics/``, counter ``store.open.bytes`` and span ``store.open``): the
ciphertext a query opens and the rate of the native open pass, in the
batched cells their entries list; nothing in a single-query cell, and
nothing from a program that keeps no such counter."""

import json
import os
import time
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

MB, GBPS = "decrypt_mb_per_q.batch", "decrypt_open_gbps.batch"
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
BATCHED = ["sift1m-scan.b64", "sift1m-probe.b64", "sift1m-scan.ycsb-d",
           "gist1m-scan.b64"]


def _reader(name):
    return harness._module(os.path.join(ROOT, "bench_torch", "metrics",
                                        f"{name}.py")).read


def _run(kind, queries, batch=64, calls=16):
    return types.SimpleNamespace(
        kind=kind, queries=queries,
        cell=types.SimpleNamespace(traffic={"batch": batch, "calls": calls}))


@pytest.mark.parametrize("name,source,better", [
    (MB, "program_counter", "lower"), (GBPS, "program_span", "higher")])
def test_the_entries_list_the_batched_cells(name, source, better):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry["workloads"] == BATCHED
    assert entry["source"] == source and entry["better"] == better
    assert entry["moves"] == "qps"
    assert entry["layer"] == "store: host AES-GCM decrypt"


def test_means_over_the_windows_roots(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    # three calls of 16 batches of 64 queries: 1,024 queries a root
    roots = [{"query.search_batches": 1, "store.open.bytes": b,
              "store.open": ns}
             for b, ns in ((1_024_000_000, 400_000_000),
                           (2_048_000_000, 600_000_000),
                           (3_072_000_000, 1_000_000_000))]
    asked = []

    def recent(root, n):
        asked.append((root, n))
        return roots[-n:]

    monkeypatch.setattr(profiler, "recent", recent)
    run = _run("batch", 3 * 16 * 64)
    # (1 + 2 + 3) MB a query over 3 roots; 6.144 GB over 2 s of opens
    assert _reader(MB)(run) == pytest.approx(2.0)
    assert _reader(GBPS)(run) == pytest.approx(3.072)
    assert asked == [("query.search_batches", 3)] * 2
    for name in (MB, GBPS):
        assert _reader(name)(_run("single", 64, batch=1, calls=64)) is None


def test_no_open_time_reads_no_rate(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "recent", lambda root, n: [
        {"query.search_batches": 1, "store.open.bytes": 0}] * n)
    assert _reader(MB)(_run("batch", 16 * 64)) == 0.0
    assert _reader(GBPS)(_run("batch", 16 * 64)) is None


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    from fspann_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "recent", lambda root, n: [
        {"query.search_batches": 1, "store.open": 5,
         "store.open.workers": 8}] * n)
    for name in (MB, GBPS):
        assert _reader(name)(_run("batch", 2 * 16 * 64)) is None
    monkeypatch.delattr(profiler, "recent")
    for name in (MB, GBPS):
        assert _reader(name)(_run("batch", 2 * 16 * 64)) is None


@pytest.mark.parametrize("cell,reads", [("sift1m-scan.b64", True),
                                        ("sift1m-scan.b1", False)])
def test_reads_in_a_traced_cpu_run(monkeypatch, cell, reads):
    """A traced run of the cell at a test size: in a batched cell the bytes
    a query are its decrypted candidates at 272 B each (256 B of f16 body
    and the 16-byte tag at d 128), and the rate is positive; a
    single-query cell reads nothing."""
    got = {}
    original = harness._read_metrics

    def read_all(run, specs):
        got.update({n: _reader(n)(run) for n in (MB, GBPS)})
        got["cand"] = [s.cand_decrypted for s in run.stats]
        return original(run, specs)

    monkeypatch.setattr(harness, "_read_metrics", read_all)
    t = time.perf_counter()
    res = harness.run_cell(ROOT, cell, 2 ** 31 + 29, 0.5, True, "cpu", t, t,
                           overrides={"n": 3000})
    assert res["correct"], res["checks"]
    if reads:
        per_q = sum(got["cand"]) / len(got["cand"]) * 272 / 1e6
        assert got[MB] == pytest.approx(per_q, rel=1e-9)
        assert isinstance(got[GBPS], float) and got[GBPS] > 0
        for name in (MB, GBPS):
            assert res["metrics"][name]["value"] == got[name]
    else:
        assert got[MB] is None and got[GBPS] is None
        assert MB not in res["metrics"] and GBPS not in res["metrics"]
