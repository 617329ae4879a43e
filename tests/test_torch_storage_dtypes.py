"""The port's mirror of ``tests/test_f16_storage.py`` and
``tests/test_i8_storage.py``, with f32 beside them: each payload dtype
through the port's store and through the whole system with both refine
backends, against the JAX package on the same seed-made inputs.

Store level: one record written by each package's store decrypts to the
same values bit for bit, and the fused C loop's norms and dots (built from
the port's copy of the C source) equal the JAX package's bit for bit.
System level (``torch_mirror``): ids, decrypt counts and recall bit for
bit, distances and ratios within 1e-5 relative; a restore serves the same
ids, as the JAX tests require."""

import numpy as np
import pytest

from fspann_tpu.crypto.keys import KeyManager as JKeyManager
from fspann_tpu.io import groundtruth as jgt
from fspann_tpu.store.point_store import PointStore as JPointStore
from fspann_tpu_torch.crypto.keys import KeyManager
from fspann_tpu_torch.io import groundtruth as tgt
from fspann_tpu_torch.store.point_store import PointStore
from torch_mirror import (assert_same_aggregates, assert_same_results,
                          built_pair, results, systems)

DIM = 16
DTYPES = ["f32", "f16", "i8"]


def _stores(tmp_path, dim, dtype):
    return (JPointStore(str(tmp_path / "jdb"), JKeyManager(
                str(tmp_path / "jks")), dim=dim, dtype=dtype),
            PointStore(str(tmp_path / "tdb"), KeyManager(
                str(tmp_path / "tks")), dim=dim, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_store_roundtrip_matches_jax(tmp_path, rng, dtype):
    vecs = (rng.normal(size=(50, 8)) * 8).astype(np.float32)
    vecs[3, :4] = [0.0, 1e-4, -1e-4, 3.14159]
    js, ts = _stores(tmp_path, 8, dtype)
    try:
        assert ts.record_ct_len == js.record_ct_len
        np.testing.assert_array_equal(ts.quantize(vecs), js.quantize(vecs))
        got = []
        for s in (js, ts):
            s.insert_batch(np.arange(50), vecs)
            out, ok = s.load_decrypt_batch(np.arange(50))
            assert ok.all()
            got.append(out)
        np.testing.assert_array_equal(got[1], got[0])
        np.testing.assert_array_equal(got[1], ts.quantize(vecs))
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_norms_and_dots_match_jax(tmp_path, rng, dtype):
    dim = 19                                    # odd: the scalar tail loop
    vecs = (rng.normal(size=(64, dim)) * 8).astype(np.float32)
    vecs[3, :4] = [0.0, 1e-4, -1e-4, 3.14159]
    qvecs = rng.normal(size=(5, dim)).astype(np.float32)
    ids = np.concatenate([np.arange(64), [999]])   # one missing id
    js, ts = _stores(tmp_path, dim, dtype)
    try:
        got = []
        for s in (js, ts):
            s.insert_batch(np.arange(64), vecs)
            norms = np.zeros(len(ids), np.float32)
            dec, ok = s.load_decrypt_batch(ids, norms_out=norms)
            norms2 = np.zeros(len(ids), np.float32)
            dots2 = np.zeros(len(ids), np.float32)
            ok2 = s.load_score_batch(ids, qvecs, 13, norms2, dots2)
            assert ok[:64].all() and not ok[64] and (ok2 == ok).all()
            got.append((dec, norms, norms2, dots2))
        for a, b in zip(got[1], got[0]):
            np.testing.assert_array_equal(a, b)
        vq = ts.quantize(vecs)
        np.testing.assert_allclose(got[1][1][:64], (vq * vq).sum(axis=1),
                                   rtol=1e-5)
    finally:
        js.close()
        ts.close()


def _cfg(dtype, backend):
    def build(c):
        return c.SystemConfig(
            paper=c.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
            runtime=c.RuntimeConfig(refinement_limit=600,
                                    max_global_candidates=600, block_size=32,
                                    storage_dtype=dtype,
                                    refine_backend=backend),
            eval=c.EvalConfig(k_variants=(1, 10))).validate()
    return build


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_e2e_recall_and_restore_match_jax(tmp_path, rng, dtype, backend):
    centers = rng.normal(size=(16, DIM)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, 1500)] + \
        rng.normal(size=(1500, DIM)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 10)] + \
        rng.normal(size=(10, DIM)).astype(np.float32)
    cfg = _cfg(dtype, backend)
    js, ts = built_pair(cfg, tmp_path, DIM, base, 500)
    try:
        assert ts.store.dtype == js.store.dtype == dtype
        agg = ts.run_queries(
            queries, tgt.precompute(base, queries, k=10, backend="torch",
                                    device="cpu"), base)
        assert_same_aggregates(
            agg, js.run_queries(queries, jgt.precompute(base, queries, k=10),
                                base))
        assert agg.recall_at_k[10] > 0.9 and agg.ratio_at_k[10] < 1.05
        before = results(ts, queries, 10)
        assert_same_results(before, results(js, queries, 10))
    finally:
        js.shutdown()
        ts.shutdown()

    # restore determinism: staging quantized through the storage dtype
    js, make = systems(cfg, tmp_path, DIM)
    ts = make()
    try:
        assert ts.restore_index_from_disk() == js.restore_index_from_disk() \
            == 1500
        after = results(ts, queries, 10)
        np.testing.assert_array_equal(after[0], before[0])
        assert_same_results(after, results(js, queries, 10))
    finally:
        js.shutdown()
        ts.shutdown()
