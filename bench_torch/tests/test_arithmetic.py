"""The rooflines against the bring-up smoke's bounds at PERF.md's shapes,
and the rate and tail over a window that holds a stall."""

import numpy as np
import pytest

from bench_torch import harness, roofline, trace


def test_approx_topk_bound():
    # approx_topk at [64, 1M], L 2,000: W = 125,056 bins
    ms, by = roofline.approx_bound_ms(64, 1_000_000, 125_056)
    assert round(ms, 4) == 0.0970 and by == "bytes"


def test_topk_bound():
    ms, by = roofline.topk_bound_ms(1_000_000, 128, 1024, 100)
    assert round(ms, 3) == 3.913 and by == "operations"


def test_hamming_bound_on_real_ids():
    # the first probe batch: 940,265 distinct rows of 96 words, 64 queries
    # by 49,152 id slots
    nbytes, ms = roofline.hamming_bound(940_265, 96, 64 * 96, 64 * 49_152)
    assert nbytes == 386_252_160 and round(ms, 4) == 0.1153


@pytest.mark.parametrize("q,by,ms", [(64, "operations", 0.1987),
                                     (1, "bytes", 0.1146)])
def test_scan_bound(q, by, ms):
    s, b = roofline.scan_bound_s(q, 1_000_000, 3072, 2000)
    assert b == by and round(s * 1e3, 4) == ms


def _run(kind):
    cell = harness.Cell("t", {"program": {"runtime": {}}},
                        {"requests": kind}, [], [])
    return harness.Run(cell, device=None)


def _read(name, run):
    import os
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    return harness._module(path).read(run)


def test_rate_counts_the_stall():
    run = _run("batch")
    # 100 batches of 1,024 queries at 1 s each, and one stall of 20 s
    run.queries, run.window_s = 100 * 1024, 100 * 1.0 + 20.0
    assert _read("qps", run) == pytest.approx(102_400 / 120.0)
    run.inserted_rows = 64 * 30
    assert _read("insert_rows_per_s", run) == pytest.approx(1920 / 120.0)


def test_tail_counts_every_request():
    run = _run("single")
    lat = [2.0] * 940 + [50.0] * 60        # a stall held 60 requests
    run.latencies_ms = lat
    assert _read("query_p95_ms", run) == pytest.approx(50.0)
    run.latencies_ms = [2.0] * 960 + [50.0] * 40
    assert _read("query_p95_ms", run) == pytest.approx(2.0)
    assert _read("query_p95_ms", _run("batch")) is None


def test_idle_share_from_intervals():
    total, merged = trace.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert total == 4 and merged == [[0, 3], [5, 6]]
    run = _run("batch")
    run.trace = trace.Trace(window_s=10.0, busy_s=2.5)
    assert _read("device_idle_share.batch", run) == pytest.approx(75.0)
    assert _read("device_idle_share.single", run) is None


def test_gap_label_is_the_innermost_span():
    spans = [(0, 100, "bench.search_batches"), (10, 20, "bench.decrypt")]
    assert trace.label_at(spans, 15) == "bench.decrypt"
    assert trace.label_at(spans, 50) == "bench.search_batches"
    assert trace.label_at(spans, 150).startswith("host")


def test_percentile_is_numpy_linear():
    run = _run("single")
    run.latencies_ms = list(np.arange(1, 101, dtype=float))
    assert _read("query_p95_ms", run) == pytest.approx(95.05)
