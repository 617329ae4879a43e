"""The plain reference against a numpy brute force, and the comparison's
numbers on answers made by hand."""

import importlib.util
import os

import numpy as np

from bench_torch import compare

from .conftest import ROOT


def _ref():
    path = os.path.join(ROOT, "bench_torch", "references", "l2_exact.py")
    spec = importlib.util.spec_from_file_location("l2_exact", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_equals_numpy_brute_force():
    ref = _ref()
    ref.CHUNK = 700                       # several blocks and merges
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(3000, 24)).astype(np.float32)
    q = rng.normal(size=(40, 24)).astype(np.float32)
    live = rng.integers(150, 3001, 40)
    stored = ref.stored_rows(rows, "f16", "cpu")
    ids, d = ref.topk(stored, q, live, 100)
    r16 = rows.astype(np.float16).astype(np.float64)
    for s in range(len(q)):
        dd = np.sqrt(((r16[:live[s]] - q[s].astype(np.float64)) ** 2)
                     .sum(1))
        want = np.lexsort((np.arange(live[s]), dd))[:100]
        assert np.array_equal(ids[s], want)
        assert np.allclose(d[s], dd[want], rtol=1e-12)
    back = ref.distances(stored, q, ids)
    assert np.allclose(back, d, rtol=1e-12)


def test_numbers_and_limits():
    ref_ids = np.tile(np.arange(100), (4, 1))
    ref_d = np.tile(np.linspace(1.0, 2.0, 100), (4, 1))
    served = ref_ids.copy()
    served[0, 9] = 150                    # one miss in a top 10
    served_ref_d = ref_d.copy()
    served_ref_d[0, 9] = 3.0
    served_d = served_ref_d.astype(np.float32) * (1 + 1e-7)
    v = compare.numbers(served, served_d, served_ref_d, ref_ids, ref_d,
                        new_from=95)
    assert v["recall10"] == 1 - 0.1 / 4
    assert v["dist_err"] < 1e-6
    assert v["ratio100"] > 1.0
    assert np.isnan(v["recall10_new"])          # no new row in a top 10
    ok, checks = compare.judge(v, {"recall10": {"min": 0.98},
                                   "dist_err": {"max": 1e-4}})
    assert not ok and not checks["recall10"]["pass"]


def test_malformed_answers():
    ids = np.tile(np.arange(5), (4, 1))
    d = np.tile(np.arange(5, dtype=np.float32), (4, 1))
    live = np.full(4, 10)
    ids[1, 3] = 1                                 # twice
    d[2] = d[2][::-1]                             # out of order
    ids[3, 0] = 12                                # not live
    assert compare.malformed(ids, d, live, 5).tolist() == [False, True,
                                                           True, True]
    ids[0, 4], d[0, 4] = -1, np.inf                # one short
    assert compare.malformed(ids, d, live, 5)[0]
