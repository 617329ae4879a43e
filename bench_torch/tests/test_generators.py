"""The corpus and the traffic generator: the same seed gives the same
data; the base does not depend on the queries drawn; YCSB's latest
generator."""

import json
import os

import numpy as np
import pytest

from bench_torch import corpus, traffic

from .conftest import ROOT

SPEC = {**json.load(open(os.path.join(
    ROOT, "bench_torch", "configs", "sift1m-scan.json")))["corpus"],
    "n": 5000}


def _gen(seed, mix_name="ycsb-d"):
    mix = corpus.mixture(SPEC)
    base, cl = corpus.base_rows(mix, seed, "cpu", chunk=1500)
    rows = traffic.Rows(base, cl)
    return traffic.Generator(traffic.load(ROOT, mix_name), mix, rows, seed)


def test_same_seed_same_data():
    a, b = _gen(2 ** 31 + 17), _gen(2 ** 31 + 17)
    assert np.array_equal(a.rows.base, b.rows.base)
    ia, ib = a.insert(), b.insert()
    assert np.array_equal(ia[0], ib[0]) and np.array_equal(ia[1], ib[1])
    assert np.array_equal(a.queries(100), b.queries(100))
    c = _gen(2 ** 31 + 18)
    assert not np.array_equal(a.rows.base, c.rows.base)


def test_mixture_is_the_deployment_not_the_seed():
    a, c = _gen(1), _gen(2)
    assert np.array_equal(np.bincount(a.rows.base_cluster),
                          np.bincount(c.rows.base_cluster))
    assert np.array_equal(np.bincount(a.rows.base_cluster),
                          corpus.mixture(SPEC).sizes)


def test_base_does_not_depend_on_queries_or_inserts():
    a = _gen(5)
    for _ in range(3):
        a.insert()
        a.queries(500)
    b = _gen(5)
    assert np.array_equal(a.rows.base, b.rows.base)
    assert len(a.rows) == len(b.rows) + 3 * 64


def test_queries_distinct_and_near_their_anchor():
    g = _gen(9, "b64")
    q = g.queries(4000)
    assert len(np.unique(q, axis=0)) == len(q)
    assert np.isfinite(q).all()


def test_inserts_take_ids_after_every_row():
    g = _gen(3)
    n = len(g.rows)
    ids, x = g.insert()
    assert np.array_equal(ids, np.arange(n, n + 64))
    got, _ = g.rows.take(ids)
    assert np.array_equal(got, x)


def _zipf_pmf(n, theta):
    w = np.arange(1, n + 1, dtype=np.float64) ** -theta
    return w / w.sum()


def test_latest_generator_matches_zipf_over_recency():
    n, theta = 1000, 0.99
    gen = traffic.LatestGenerator(n, theta)
    pmf = _zipf_pmf(n, theta)
    assert gen.zetan == pytest.approx(1 / pmf[0] * 1.0, rel=1e-12)
    rng = np.random.default_rng(0)
    ids = gen.sample(rng, 400_000)
    assert ids.min() >= 0 and ids.max() == n - 1
    ranks = (n - 1) - ids
    freq = np.bincount(ranks, minlength=n) / len(ranks)
    # ranks 0 and 1 exactly as Zipf; the tail by Gray et al.'s
    # approximation, whose CDF stays within a few points of Zipf's
    assert freq[0] == pytest.approx(pmf[0], abs=0.003)
    assert freq[1] == pytest.approx(pmf[1], abs=0.003)
    cdf, want = np.cumsum(freq), np.cumsum(pmf)
    assert np.abs(cdf - want).max() < 0.03


def test_latest_generator_grows_like_a_fresh_one():
    g = traffic.LatestGenerator(500, 0.99)
    g.grow(700)
    fresh = traffic.LatestGenerator(700, 0.99)
    assert g.zetan == pytest.approx(fresh.zetan, rel=1e-12)
    u = np.linspace(0, 0.999, 50)
    assert np.array_equal(g.ranks(u), fresh.ranks(u))
