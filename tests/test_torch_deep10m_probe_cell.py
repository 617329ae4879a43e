"""The benchmark's ``deep10m-probe.b64`` cell on the CPU at a small size.

The cell keeps its whole shape (d 96; m 24, lambda 2 over 6 tables x 8
divisions, so 48 groups of 2 words, 96 words and 2,304 bits a row; 16
probes of 128-row blocks, re-rank to 4,000, narrow keys; 10M rows in the
configuration's file) and runs here over 8,192 seeded rows in 64 clusters
(the generator's default for that many rows; the file's 10,000 clusters
need at least as many rows): a sound run reads correct against the plain
``l2_exact`` reference, and the control (the program's int8 storage, the
precision below the configuration's f16) reads not correct by
``dist_err``.  On the CPU the re-rank's ``code_hamming`` runs its plain
version, a gather, so every slot counts as gathered."""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_torch import harness  # noqa: E402

CELL = "deep10m-probe.b64"
SMALL = {"n": 8192, "n_clusters": 64}
# one batch of 64 a cycle, one cycle in the window
MIX = {"calls": 1}


def _run(control=False):
    t = time.perf_counter()
    return harness.run_cell(ROOT, CELL, 2 ** 31 + 79, 0.01, False, "cpu", t,
                            t, control=control, overrides=SMALL,
                            traffic_overrides=MIX)


def test_the_cell_keeps_the_deep_probe_shape():
    cell = harness.Cell.find(ROOT, CELL)
    corpus, program = cell.config["corpus"], cell.config["program"]
    with open(os.path.join(ROOT, "bench_torch", "configs",
                           "deep10m-scan.json")) as f:
        assert corpus == json.load(f)["corpus"]
    assert (corpus["n"], corpus["d"], corpus["d_eff"],
            corpus["n_clusters"]) == (10_000_000, 96, 24, 10_000)
    cfg = harness.system_config(program)
    pp, rt = cfg.paper, cfg.runtime
    assert (pp.m, pp.lam, pp.tables, pp.divisions) == (24, 2, 6, 8)
    assert (pp.num_groups, pp.code_words) == (48, 2)
    assert pp.num_groups * pp.code_words == 96
    assert pp.num_groups * pp.code_bits == 2304
    assert (rt.routing_mode, rt.effective_probes(), rt.block_size,
            rt.rerank_limit) == ("probe", 16, 128, 4000)
    assert (rt.refinement_limit, rt.max_global_candidates) == (40_000,
                                                               40_000)
    # 48-bit group keys sort exactly: no second key
    assert pp.code_bits == 48 and not rt.wide_keys_active(pp.code_bits)
    assert (rt.storage_dtype, rt.encode_backend, rt.refine_backend,
            rt.adaptive_decrypt_margin) == ("f16", "default", "device", 40)
    assert program["runtime"]["setup_threads"] == rt.setup_threads == 0
    assert (program["query_batch"], program["ingest_batch"]) == (64,
                                                                100_000)
    assert cell.traffic["requests"] == "batch" and cell.chips == 1
    assert cell.config["reference"] == "l2_exact"
    assert cell.config["control"] == {"runtime": {"storage_dtype": "i8"}}
    assert cell.config["limits"] == {"dist_err": {"max": 5e-4},
                                     "recall10": {"min": 0.55},
                                     "ratio100": {"max": 1.03}}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        (entry,) = [c for c in json.load(f)["configs"]
                    if c["name"] == "deep10m-probe"]
    assert entry["reduced"] == []


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    limit = harness.Cell.find(ROOT, CELL).config["limits"]["recall10"]
    assert out["checks"]["recall10"]["value"] >= limit["min"]


def test_control_fails_by_dist_err():
    out = _run(control=True)
    assert not out["correct"]
    c = out["checks"]["dist_err"]
    assert c["value"] > float(c["limit"].split()[-1])
