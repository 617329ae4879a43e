"""Port's device refine (fspann_tpu_torch/ops/refine.refine) against the JAX
package's ``ops/refine.refine``.

Same seeded [Q, R, d] candidates, validity mask and ids through both.
Distances agree within rtol 1e-6 (float32 sums of d squared differences
taken in another order, then a square root); ids are equal wherever the
distances are not tied, and ties resolve to the lower candidate column in
both (``lax.top_k``'s order, the port's ``(sortable(d²), column)`` key)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.ops import refine as jrefine
from fspann_tpu_torch.ops import refine

torch.set_num_threads(1)

RTOL = 1e-6


def _inputs(rng, q, r, d, p_valid=0.8):
    qv = rng.normal(size=(q, d)).astype(np.float32)
    cv = rng.normal(size=(q, r, d)).astype(np.float32)
    ids = rng.permutation(10 * q * r)[:q * r].reshape(q, r).astype(np.int32)
    valid = rng.random((q, r)) < p_valid
    cv[~valid] = np.nan          # garbage where invalid must not leak
    return qv, cv, ids, valid


def _both(qv, cv, ids, valid, k):
    j = jrefine.refine(jnp.asarray(qv), jnp.asarray(cv), jnp.asarray(ids),
                       jnp.asarray(valid), k)
    t = refine.refine(torch.from_numpy(qv), torch.from_numpy(cv),
                      torch.from_numpy(ids), torch.from_numpy(valid), k)
    return j, t


@pytest.mark.parametrize("q,r,d,k", [(4, 50, 16, 10), (7, 300, 128, 100),
                                     (1, 10, 8, 10)])
def test_refine_matches_jax(rng, q, r, d, k):
    j, t = _both(*_inputs(rng, q, r, d), k)
    assert t.ids.dtype == torch.int32 and t.distances.dtype == torch.float32
    jd, td = np.asarray(j.distances), t.distances.numpy()
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=RTOL)
    np.testing.assert_array_equal(t.n_scored.numpy(), np.asarray(j.n_scored))
    jid, tid = np.asarray(j.ids), t.ids.numpy()
    np.testing.assert_array_equal(tid[~fin], -1)
    for i in range(q):
        d_i = jd[i]
        untied = np.ones(k, bool)
        close = np.isclose(d_i[1:], d_i[:-1], rtol=RTOL, atol=0)
        untied[1:] &= ~close
        untied[:-1] &= ~close
        np.testing.assert_array_equal(tid[i][untied], jid[i][untied])


def test_refine_exact_ties_take_the_lower_column(rng):
    """Integer coordinates make every distance exact: duplicated candidates
    tie exactly and both packages keep the lower column first."""
    qv = rng.integers(-3, 4, size=(3, 6)).astype(np.float32)
    cv = np.repeat(rng.integers(-3, 4, size=(3, 20, 6)), 3, axis=1) \
        .astype(np.float32)
    ids = np.arange(3 * 60, dtype=np.int32).reshape(3, 60)
    valid = np.ones((3, 60), bool)
    valid[:, ::7] = False
    j, t = _both(qv, cv, ids, valid, 25)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.distances.numpy(),
                                  np.asarray(j.distances))


def test_refine_all_invalid_and_fewer_candidates_than_k(rng):
    qv, cv, ids, valid = _inputs(rng, 2, 5, 4, p_valid=0.0)
    t = refine.refine(torch.from_numpy(qv), torch.from_numpy(cv),
                      torch.from_numpy(ids), torch.from_numpy(valid), 8)
    assert tuple(t.ids.shape) == (2, 8)
    assert (t.ids == -1).all() and torch.isinf(t.distances).all()
    assert (t.n_scored == 0).all()


@pytest.mark.parametrize("with_c2", [True, False])
def test_host_refine_matches_jax_and_the_scored_path(rng, with_c2):
    """``query/service._host_refine`` (stage C from candidate vectors) equals
    the JAX package's bit for bit, and the fused path's
    ``_host_refine_scored`` on consistent norms and dots (ids and counts
    equal, distances within 1e-6 as in ``tests/test_refine.py``)."""
    from fspann_tpu.query.service import _host_refine as jhost_refine
    from fspann_tpu_torch.query.service import (_host_refine,
                                                _host_refine_scored)

    q, r, d, k = 5, 64, 16, 10
    qvecs = rng.normal(size=(q, d)).astype(np.float32)
    cand = rng.normal(size=(q, r, d)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(q, r)).astype(np.int64)
    valid = rng.random(size=(q, r)) > 0.2
    dots = np.einsum("qrd,qd->qr", cand, qvecs).astype(np.float32)
    c2 = np.einsum("qrd,qrd->qr", cand, cand).astype(np.float32)
    kw = {"c2": c2} if with_c2 else {}
    got = _host_refine(qvecs, cand, ids, valid, k, **kw)
    for a, b in zip(got, jhost_refine(qvecs, cand, ids, valid, k, **kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    i2, d2, n2 = _host_refine_scored(qvecs, dots, c2, ids, valid, k)
    np.testing.assert_array_equal(got[0], i2)
    np.testing.assert_allclose(got[1], d2, rtol=1e-6)
    np.testing.assert_array_equal(got[2], n2)
