"""The comparison at a test size on the CPU: a sound run comes out
correct; the control (the program's int8 storage path, the precision
below the configuration's f16) and each fault the cells can have, planted
in the timed path, come out not correct."""

import time

import numpy as np
import pytest

from bench_torch import harness

from .conftest import ROOT

SMALL = {"n": 3000}


def _run(cell, seconds=0.5, control=False, seed=2 ** 31 + 5, traced=False,
         mix=None):
    t = time.perf_counter()
    return harness.run_cell(ROOT, cell, seed, seconds, traced, "cpu", t, t,
                            control=control, overrides=SMALL,
                            traffic_overrides=mix)


@pytest.mark.parametrize("cell", ["sift1m-scan.b64", "sift1m-scan.b1",
                                  "sift1m-scan.ycsb-d"])
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def test_sound_traced_probe_run_is_correct():
    # the probe route's plain twins take seconds a batch on the CPU
    out = _run("sift1m-probe.b64", seconds=0.01, traced=True,
               mix={"calls": 1})
    assert out["correct"], out["checks"]
    assert "cand_decrypted_per_q.batch" in out["metrics"]
    assert "breakdown" in out


def test_control_fails():
    out = _run("sift1m-scan.b64", control=True)
    assert not out["correct"]
    c = out["checks"]["dist_err"]
    assert c["value"] > 10 * float(c["limit"].split()[-1])


def test_insert_leaving_the_state_unchanged_fails(monkeypatch):
    from fspann_tpu_torch.index.service import PartitionedIndex

    monkeypatch.setattr(PartitionedIndex, "append_rows",
                        lambda self, ids, vecs: None)
    out = _run("sift1m-scan.ycsb-d", seconds=1.0)
    assert not out["correct"]
    assert out["checks"]["recall10_new"]["value"] < 0.5


def _wrap_batches(monkeypatch, change):
    from fspann_tpu_torch.query.service import QueryService

    served = QueryService.search_batches

    def broken(self, batches):
        res = served(self, batches)
        for r in res:
            change(r)
        return res

    monkeypatch.setattr(QueryService, "search_batches", broken)


def test_half_the_batch_left_out_fails(monkeypatch):
    def half(r):
        h = len(r.ids) // 2
        r.ids[h:] = -1
        r.distances[h:] = np.inf

    _wrap_batches(monkeypatch, half)
    out = _run("sift1m-scan.b64")
    assert not out["correct"] and out["failed"] > 0


def test_altered_answer_fails(monkeypatch):
    def shift(r):
        r.ids[:, 0] = (r.ids[:, 0] + 1) % 1000

    _wrap_batches(monkeypatch, shift)
    out = _run("sift1m-scan.b64")
    assert not out["correct"]
    assert out["checks"]["dist_err"]["value"] > 1e-3
