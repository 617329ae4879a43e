"""The port's sharded index (fspann_tpu_torch/parallel/sharded.py) against the
JAX package's, on the 8-device CPU mesh of tests/conftest.py (JAX) and 8 row
ranges of one CPU tensor (the port), the JAX bank carried across with
``bank_from_jax``.

Both packages encode ON THE DEVICE here, and their float32 products may
round a projection on a bucket boundary differently
(tests/test_torch_coding.py bounds that at 1e-4 of the bits).  So that the
comparisons below are bit for bit on any host, the inputs sit on a grid
where every projection is exact in float32 whatever the order of the sum:
vectors are multiples of 1/16 and the bank's ``alpha`` is rounded to
multiples of 2^-10 (|sum of 16..32 products| < 2^10, 14 fractional bits).
Each test asserts the CODES equal first; every integer output downstream
(stacked tables, ids, scores) is then compared bit for bit, with
``approx=False`` on the JAX side (the port's default; both packages'
``approx=True`` are compared in tests/test_torch_approx_topk.py).
``query`` distances: squared differences of grid points are exact too, so
ids are equal including ties (both sides keep the lower candidate position)
and distances agree to 1e-6 relative (the JAX tests allow 1e-4).

Mirrors ``__graft_entry__.dryrun_multichip``, tests/test_sharded.py, the
index-level tests of tests/test_distributed_serving.py and
tests/test_wide_keys.py::test_mesh_wide_matches_single_chip."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import refine as jrefine
from fspann_tpu.parallel.sharded import ShardedIndex as JIndex
from fspann_tpu.parallel.sharded import make_mesh as jmake_mesh
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops import hamming_scan as ths
from fspann_tpu_torch.parallel import sharded as tsharded
from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh

torch.set_num_threads(1)

DIST_RTOL = 1e-6


def _grid(x):
    return (np.round(np.asarray(x, np.float64) * 16) / 16).astype(np.float32)


def _banks(sample, m=8, lam=2, tables=3, divisions=2, seed=13):
    """(JAX bank, the same bank in the port), ``alpha`` on the 2^-10 grid."""
    jb = jcoding.build_bank_from_sample(sample, m, lam, tables, divisions,
                                        seed)
    alpha = (np.round(np.asarray(jb.alpha, np.float64) * 1024) / 1024) \
        .astype(np.float32)
    jb = dataclasses.replace(jb, alpha=alpha)
    return jb, bank_from_jax(alpha, np.asarray(jb.r), np.asarray(jb.omega),
                             jb.m, jb.lam, jb.tables, jb.divisions, jb.seed)


def _pair(jb, bank, nd=None, block=32, wide=False):
    jmesh = jmake_mesh(nd)
    return (JIndex(jmesh, jb, block_size=block, wide_keys=wide),
            ShardedIndex(make_mesh(jmesh.devices.size, device="cpu"), bank,
                         block_size=block, wide_keys=wide))


def _assert_codes_equal(jb, bank, x):
    """The premise of every bit-for-bit comparison below."""
    jc, jk = jcoding.encode(jnp.asarray(x), jb)
    tc, tk = coding.encode(torch.from_numpy(np.ascontiguousarray(x)), bank)
    np.testing.assert_array_equal(coding.words_to_numpy(tc), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def _assert_tables_equal(j, t):
    assert j.shard_rows == t.shard_rows and j.n == t.n
    for f in j.table._fields:
        a = getattr(j.table, f)
        b = [getattr(tb, f) for tb in t._per_device(t.table)]
        if a is None:
            assert all(p is None for p in b), f
            continue
        a, b = j._gather_host(a), t._gather_host(b)
        if f == "rep_codes":
            b = b.view(np.uint32)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _assert_state_equal(j, t):
    for f in ("point_codes", "words", "bits", "popc", "tombs"):
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            b = t._gather_host(b)
            if b.dtype == np.int32 and f != "popc":
                b = b.view(np.uint32)
            np.testing.assert_array_equal(b, j._gather_host(a), err_msg=f)


def _assert_same(got, want, what=""):
    for g, w, name in zip(got, want, ("ids", "scores")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == np.int32 and g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def _assert_query_same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=DIST_RTOL)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32


def test_dryrun_multichip_equalities():
    """Every path ``__graft_entry__.dryrun_multichip`` drives, at its shapes,
    JAX against the port."""
    nd = 8
    n, d, q, k = 64 * nd, 32, 4, 5
    rng = np.random.default_rng(0)
    base = _grid(rng.normal(size=(n, d)))
    queries = _grid(rng.normal(size=(q, d)))
    jb, bank = _banks(base, m=8, lam=2, tables=2, divisions=2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank, nd, block=16)
    for idx in (j, t):
        idx.build(base, keep_codes=True, keep_bits=True)
    _assert_tables_equal(j, t)
    _assert_state_equal(j, t)
    np.testing.assert_array_equal(t._gather_host(t.base),
                                  j._gather_host(j.base))

    jstep = jax.jit(j.query_step_fn(probes=2, refinement_limit=64, k=k))
    jids, jdist = jstep(j.table, j.base, j.tombs, jnp.asarray(queries))
    tids, tdist = t.query_step_fn(probes=2, refinement_limit=64, k=k)(
        t.table, t.base, t.tombs, torch.from_numpy(queries))
    _assert_query_same((tids.numpy(), tdist.numpy()), (jids, jdist))
    d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
    true_ids = np.argsort(d2, axis=1)[:, :k]
    hits = sum(len(set(tids[i].tolist()) & set(true_ids[i].tolist()))
               for i in range(q))
    assert hits / (q * k) >= 0.9

    rr = t.route(queries, probes=2, refinement_limit=64, rerank_limit=32)
    _assert_same(rr, j.route(queries, probes=2, refinement_limit=64,
                             rerank_limit=32), "rerank route")
    assert rr[0].shape[1] == 32 and (rr[0] >= 0).any()
    sc = t.scan_route(queries, limit=32)
    jsc = j.scan_route(queries, limit=32, approx=False)
    _assert_same(sc, jsc, "scan route")

    j2, t2 = _pair(jb, bank, nd, block=16)
    for idx in (j2, t2):
        assert idx.build_stream((base[i:i + 50] for i in range(0, n, 50)),
                                n, keep_bits=True) == n
    _assert_tables_equal(j2, t2)
    _assert_state_equal(j2, t2)
    _assert_same(t2.scan_route(queries, limit=32), sc, "streamed")

    j3, t3 = _pair(jb, bank, nd, block=16)
    for idx in (j3, t3):
        idx.build(base, keep_base=False, keep_bits="packed")
    _assert_state_equal(j3, t3)
    _assert_same(t3.scan_route(queries, limit=32), sc, "packed")
    j3.merge_backend = t3.merge_backend = "host"
    _assert_same(t3.scan_route(queries, limit=32), sc, "host merge")
    _assert_same(j3.scan_route(queries, limit=32, approx=False), sc,
                 "JAX host merge")

    jbw, bankw = _banks(base, m=24, lam=3, tables=2, divisions=2)
    _assert_codes_equal(jbw, bankw, base)
    j4, t4 = _pair(jbw, bankw, nd, block=16, wide=True)
    for idx in (j4, t4):
        idx.build(base, keep_base=False, keep_codes=True, keep_bits=False)
    assert t4.table[0].min_key2 is not None
    _assert_tables_equal(j4, t4)
    wk = t4.route(queries, probes=2, refinement_limit=64)
    _assert_same(wk, j4.route(queries, probes=2, refinement_limit=64),
                 "wide route")
    assert (wk[0] >= 0).any()


def _clusters(rng, n, d, q, spread=5.0):
    centers = rng.normal(size=(16, d)).astype(np.float32) * spread
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)
    return _grid(base), _grid(queries)


def test_sharded_matches_bruteforce(rng):
    n, d, q, k = 4000, 16, 8, 10
    base, queries = _clusters(rng, n, d, q)
    jb, bank = _banks(base[:1000])
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank)
    for idx in (j, t):
        idx.build(base)
    _assert_tables_equal(j, t)
    ids, dist = t.query(queries, probes=4, refinement_limit=512, k=k)
    _assert_query_same((ids, dist), j.query(queries, probes=4,
                                            refinement_limit=512, k=k))
    gt_ids, _ = jrefine.bruteforce_topk(base, queries, k)
    hits = sum(len(set(ids[i].tolist()) & set(gt_ids[i].tolist()))
               for i in range(q))
    assert hits / (q * k) > 0.9
    for i in range(q):
        live = ids[i] >= 0
        d_true = np.linalg.norm(base[ids[i][live]] - queries[i], axis=1)
        np.testing.assert_allclose(dist[i][live], d_true, rtol=1e-4)
        assert np.all(np.diff(dist[i][live]) >= -1e-6)


def test_sharded_padding_masked(rng):
    """N not divisible by the shard count: padded rows never appear, and
    the pad rows (copies of the last row) give JAX's tables."""
    n, d = 1003, 8
    base = _grid(rng.normal(size=(n, d)) * 3)
    jb, bank = _banks(base, m=6, lam=2, tables=2, divisions=2, seed=5)
    _assert_codes_equal(jb, bank, base)
    j, t = _pair(jb, bank, block=16)
    for idx in (j, t):
        idx.build(base)
    _assert_tables_equal(j, t)
    ids, dist = t.query(base[:4], probes=3, refinement_limit=256, k=5)
    _assert_query_same((ids, dist), j.query(base[:4], probes=3,
                                            refinement_limit=256, k=5))
    assert ids.max() < n
    assert (ids[:, 0] == np.arange(4)).all()
    np.testing.assert_allclose(dist[:, 0], 0, atol=1e-3)


def test_probe_shards_subset(rng):
    n, d, q, k = 2048, 8, 4, 10
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(rng.normal(size=(q, d)) * 3)
    jb, bank = _banks(base[:800], m=6, lam=2, tables=2, divisions=2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank, block=16)
    for idx in (j, t):
        idx.build(base, keep_bits=True)
    subset = 2
    ids, dist = t.query(queries, probes=3, refinement_limit=256, k=k,
                        probe_shards=subset)
    _assert_query_same((ids, dist), j.query(
        queries, probes=3, refinement_limit=256, k=k, probe_shards=subset))
    live = ids[ids >= 0]
    assert len(live) and (live < subset * t.shard_rows).all()
    ids_full, _ = t.query(queries, probes=3, refinement_limit=256, k=k)
    assert (ids_full[ids_full >= 0] >= subset * t.shard_rows).any()
    # the route-only steps take the same cap
    for kw in (dict(probes=3, refinement_limit=64),):
        got = t.route(queries, probe_shards=subset, **kw)
        _assert_same(got, j.route(queries, probe_shards=subset, **kw))
        assert (got[0][got[0] >= 0] < subset * t.shard_rows).all()
    got = t.scan_route(queries, limit=40, probe_shards=subset)
    _assert_same(got, j.scan_route(queries, limit=40, probe_shards=subset,
                                   approx=False))
    assert (got[0] < subset * t.shard_rows).all() and (got[0] >= 0).all()


def _near(rng, base, q, noise=0.1):
    return _grid(base[rng.integers(0, len(base), q)]
                 + rng.normal(size=(q, base.shape[1])) * noise)


def test_sharded_rerank_matches_global_fine_hamming(rng):
    n, d = 1024, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _near(rng, base, 5)
    jb, bank = _banks(base[:1000])
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank)
    for idx in (j, t):
        idx.build(base, keep_base=False, keep_codes=True)
    wide_r, limit = 1024, 60
    wide = t.route(queries, probes=3, refinement_limit=wide_r)
    _assert_same(wide, j.route(queries, probes=3, refinement_limit=wide_r),
                 "route")
    got_ids, got_sc = t.route(queries, probes=3, refinement_limit=wide_r,
                              rerank_limit=limit)
    _assert_same((got_ids, got_sc), j.route(
        queries, probes=3, refinement_limit=wide_r, rerank_limit=limit),
        "rerank")
    codes_np = coding.words_to_numpy(
        coding.encode(torch.from_numpy(base), bank)[0])
    qc_np = coding.words_to_numpy(
        coding.encode(torch.from_numpy(queries), bank)[0])
    for qi in range(len(queries)):
        cand = [int(x) for x in wide[0][qi] if x >= 0]
        fine = {c: int(np.unpackbits(np.bitwise_xor(
            codes_np[c], qc_np[qi]).view(np.uint8)).sum()) for c in cand}
        exp = sorted(cand, key=lambda c: (fine[c], c))[:limit]
        assert [int(x) for x in got_ids[qi] if x >= 0] == exp, f"q={qi}"
        live_sc = [int(s) for x, s in zip(got_ids[qi], got_sc[qi]) if x >= 0]
        assert live_sc == [fine[c] for c in exp]
    with pytest.raises(RuntimeError, match="keep_codes"):
        bare = ShardedIndex(make_mesh(2, device="cpu"), bank)
        bare.build(base, keep_base=False)
        bare.route(queries, rerank_limit=10)


def test_mesh_scan_matches_single_device_oracle(rng):
    n, d = 1024, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _near(rng, base, 5)
    jb, bank = _banks(base[:1000])
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank)
    for idx in (j, t):
        idx.build(base, keep_base=False, keep_bits=True)
    limit = 60
    got_ids, got_sc = t.scan_route(queries, limit=limit)
    _assert_same((got_ids, got_sc),
                 j.scan_route(queries, limit=limit, approx=False))
    bits = ths.unpack_bits_numpy(coding.words_to_numpy(
        coding.encode(torch.from_numpy(base), bank)[0]), bank.code_bits)
    qbits = ths.unpack_bits_numpy(coding.words_to_numpy(
        coding.encode(torch.from_numpy(queries), bank)[0]), bank.code_bits)
    for qi in range(len(queries)):
        fine = np.bitwise_xor(bits, qbits[qi]).sum(axis=1)
        exp = sorted(range(n), key=lambda c: (int(fine[c]), c))[:limit]
        assert [int(x) for x in got_ids[qi] if x >= 0] == exp, f"q={qi}"
        live_sc = [int(s) for x, s in zip(got_ids[qi], got_sc[qi]) if x >= 0]
        assert live_sc == [int(fine[c]) for c in exp]


def test_build_stream_matches_oneshot(rng):
    n, d = 1600, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(rng.normal(size=(5, d)) * 3)
    jb, bank = _banks(base[:512], 8, 2, 2, 2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    one_j, one = _pair(jb, bank, block=16)
    st_j, st = _pair(jb, bank, block=16)
    sizes = [300, 77, 423, 400, 256, 144]      # ragged, crossing shards
    off = np.cumsum([0] + sizes)
    for idx in (one_j, one):
        idx.build(base, keep_base=False, keep_bits=True)
    for idx in (st_j, st):
        assert idx.build_stream((base[a:b] for a, b in zip(off, off[1:])), n,
                                keep_bits=True) == n
    assert st.shard_rows == one.shard_rows
    _assert_tables_equal(st_j, st)
    _assert_tables_equal(one_j, one)
    _assert_state_equal(st_j, st)
    a = one.scan_route(queries, limit=64)
    _assert_same(st.scan_route(queries, limit=64), a, "stream vs one-shot")
    _assert_same(a, st_j.scan_route(queries, limit=64, approx=False), "JAX")
    r_a = one.route(queries, probes=3, refinement_limit=128)
    _assert_same(st.route(queries, probes=3, refinement_limit=128), r_a)
    _assert_same(r_a, st_j.route(queries, probes=3, refinement_limit=128))
    # a tail shard short of rows is zero-padded, as in JAX
    short_j, short = _pair(jb, bank, block=16)
    for idx in (short_j, short):
        idx.build_stream(iter([base[:700], base[700:1001]]), 1001,
                         keep_bits=True, keep_codes=True, capacity=1500)
    _assert_tables_equal(short_j, short)
    _assert_state_equal(short_j, short)
    for bad, match in (([base[:900], base[900:]], "longer"),
                       ([base[:100]], "provided 100")):
        with pytest.raises(ValueError, match=match):
            _pair(jb, bank)[1].build_stream(iter(bad), 800)


@pytest.mark.parametrize("layout", [True, "packed"])
def test_mesh_live_insert_matches_full_build(rng, layout):
    n0, n1, d, cap = 1500, 300, 16, 2048
    base = _grid(rng.normal(size=(n0 + n1, d)) * 3)
    queries = _grid(rng.normal(size=(5, d)) * 3)
    jb, bank = _banks(base[:512], 8, 2, 2, 2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    live_j, live = _pair(jb, bank, block=16)
    for idx in (live_j, live):
        idx.build(base[:n0], keep_base=False, keep_bits=layout, capacity=cap)
    state = (live.words if layout == "packed" else live.bits)[0]
    ptrs = (state.data_ptr(), live.popc[0].data_ptr(), tuple(state.shape))
    before = live.scan_route(queries, limit=64)
    for idx in (live_j, live):
        ids = idx.append_scan_rows(base[n0:])
        np.testing.assert_array_equal(ids, np.arange(n0, n0 + n1))
        assert idx.n == n0 + n1
    state = (live.words if layout == "packed" else live.bits)[0]
    assert (state.data_ptr(), live.popc[0].data_ptr(),
            tuple(state.shape)) == ptrs, "the insert moved the scan state"
    _assert_state_equal(live_j, live)
    full = _pair(jb, bank, block=16)[1]
    full.build(base, keep_base=False, keep_bits=layout, capacity=cap)
    a = live.scan_route(queries, limit=64)
    _assert_same(a, full.scan_route(queries, limit=64), "live vs full")
    _assert_same(a, live_j.scan_route(queries, limit=64, approx=False))
    # the same step sees the insert: the live count is read at every call
    assert not np.array_equal(a[0], before[0]) or n1 == 0
    with pytest.raises(RuntimeError, match="capacity"):
        live.append_scan_rows(_grid(rng.normal(size=(cap, d))))
    bare = _pair(jb, bank)[1]
    bare.build(base[:n0], keep_base=False)
    with pytest.raises(RuntimeError, match="keep_bits"):
        bare.append_scan_rows(base[n0:])


def test_mesh_checkpoint_restore_roundtrip(tmp_path, rng):
    n, d = 1600, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(rng.normal(size=(5, d)) * 3)
    jb, bank = _banks(base[:512], 8, 2, 2, 2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    one_j, one = _pair(jb, bank, block=16)
    for idx in (one_j, one):
        idx.build(base, keep_base=False, keep_bits=True, keep_codes=True)
    path = str(tmp_path / "mesh_state.npz")
    one.save_state(path)
    back = ShardedIndex.restore_state(path, make_mesh(8, device="cpu"),
                                      keep_codes=True, keep_bits=True)
    assert back.n == n and back.shard_rows == one.shard_rows
    _assert_tables_equal(one_j, back)
    _assert_state_equal(one_j, back)
    a = one.scan_route(queries, limit=64)
    _assert_same(back.scan_route(queries, limit=64), a)
    _assert_same(a, one_j.scan_route(queries, limit=64, approx=False))
    r_a = one.route(queries, probes=3, refinement_limit=128)
    _assert_same(back.route(queries, probes=3, refinement_limit=128), r_a)
    _assert_same(r_a, one_j.route(queries, probes=3, refinement_limit=128))
    with pytest.raises(ValueError, match="8 devices"):
        ShardedIndex.restore_state(path, make_mesh(4, device="cpu"))


def test_jax_checkpoint_restores_with_alpha_and_without(tmp_path, rng):
    """The port's ``mesh_state.npz`` is the JAX file plus ``alpha``.  The
    JAX file itself (no ``alpha``) restores in the port with ``alpha``
    regenerated from the seed, as JAX's restore does, and so does a copy
    with the bank's ``alpha`` added; both serve JAX's routes."""
    n, d = 1200, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(rng.normal(size=(5, d)) * 3)
    jb, bank = _banks(base[:512], 8, 2, 2, 2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank, block=16)
    for idx in (j, t):
        idx.build(base, keep_base=False, keep_bits=True, keep_codes=True)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    j.save_state(jpath)
    t.save_state(tpath)
    jz, tz = np.load(jpath), np.load(tpath)
    assert sorted(tz.files) == sorted(jz.files + ["alpha"])
    for key in jz.files:
        assert tz[key].dtype == jz[key].dtype, key
        np.testing.assert_array_equal(tz[key], jz[key], err_msg=key)
    mesh = make_mesh(8, device="cpu")
    with_alpha = str(tmp_path / "jax_alpha.npz")
    np.savez(with_alpha, alpha=np.asarray(jb.alpha),
             **{key: jz[key] for key in jz.files})
    back = ShardedIndex.restore_state(with_alpha, mesh, keep_codes=True)
    _assert_tables_equal(j, back)
    _assert_same(back.scan_route(queries, limit=64),
                 j.scan_route(queries, limit=64, approx=False))
    _assert_same(back.route(queries, probes=3, refinement_limit=128,
                            rerank_limit=40),
                 j.route(queries, probes=3, refinement_limit=128,
                         rerank_limit=40))

    # the JAX file as JAX writes it, from a bank JAX drew from the seed
    # (the grid bank above is not the seed's): alpha regenerates bit for bit
    raw = jcoding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    jr = JIndex(jmake_mesh(), raw, block_size=16)
    jr.build(base, keep_base=False, keep_bits=True, keep_codes=True)
    jr.save_state(jpath)
    back = ShardedIndex.restore_state(jpath, mesh, keep_codes=True)
    for f in ("alpha", "r", "omega"):
        np.testing.assert_array_equal(
            getattr(back.bank, f).view(np.uint32),
            np.asarray(getattr(raw, f)).view(np.uint32), err_msg=f)
    _assert_tables_equal(jr, back)
    _assert_state_equal(jr, back)
    _assert_codes_equal(raw, back.bank, queries)
    _assert_same(back.scan_route(queries, limit=64),
                 jr.scan_route(queries, limit=64, approx=False))
    _assert_same(back.route(queries, probes=3, refinement_limit=128,
                            rerank_limit=40),
                 jr.route(queries, probes=3, refinement_limit=128,
                          rerank_limit=40))


def test_mesh_checkpoint_from_bits_only(tmp_path, rng):
    n, d = 800, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(rng.normal(size=(4, d)) * 3)
    jb, bank = _banks(base[:512], 8, 2, 2, 2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    one_j, one = _pair(jb, bank, block=16)
    for idx in (one_j, one):
        idx.build(base, keep_base=False, keep_bits=True)   # no codes kept
    jpath, path = str(tmp_path / "j.npz"), str(tmp_path / "mesh_bits.npz")
    one_j.save_state(jpath)
    one.save_state(path)
    np.testing.assert_array_equal(np.load(path)["codes"],
                                  np.load(jpath)["codes"])
    back = ShardedIndex.restore_state(path, make_mesh(8, device="cpu"))
    a = one.scan_route(queries, limit=32)
    _assert_same(back.scan_route(queries, limit=32), a)
    _assert_same(a, one_j.scan_route(queries, limit=32, approx=False))
    empty = _pair(jb, bank)[1]
    empty.build(base, keep_base=False)
    with pytest.raises(RuntimeError, match="nothing to save"):
        empty.save_state(path)


def test_sharded_index_mark_deleted_all_paths(rng):
    n, d = 1024, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    jb, bank = _banks(base[:512], 8, 2, 2, 2)
    _assert_codes_equal(jb, bank, base)
    j, t = _pair(jb, bank, block=16)
    for idx in (j, t):
        idx.build(base, keep_base=True, keep_bits=True, keep_codes=True)
    dead = np.arange(0, n, 7)
    queries = base[dead[:4]].copy()
    alive = t.scan_route(queries, limit=32)
    tombs_ptr = t.tombs[0].data_ptr()
    for idx in (j, t):
        idx.mark_deleted(dead)
    assert t.tombs[0].data_ptr() == tombs_ptr
    _assert_state_equal(j, t)
    s = t.scan_route(queries, limit=32)
    _assert_same(s, j.scan_route(queries, limit=32, approx=False))
    assert not np.isin(s[0], dead).any()
    assert np.isin(alive[0], dead).any()      # the same step saw the delete
    r = t.route(queries, probes=3, refinement_limit=64)
    _assert_same(r, j.route(queries, probes=3, refinement_limit=64))
    assert not np.isin(r[0][r[0] >= 0], dead).any()
    rr = t.route(queries, probes=3, refinement_limit=64, rerank_limit=32)
    _assert_same(rr, j.route(queries, probes=3, refinement_limit=64,
                             rerank_limit=32))
    assert not np.isin(rr[0][rr[0] >= 0], dead).any()
    qq = t.query(queries, probes=3, refinement_limit=64, k=5)
    _assert_query_same(qq, j.query(queries, probes=3, refinement_limit=64,
                                   k=5))
    assert not np.isin(qq[0][qq[0] >= 0], dead).any()
    for idx in (j, t):
        idx.mark_undeleted(dead[:10])
    _assert_same(t.scan_route(queries, limit=32),
                 j.scan_route(queries, limit=32, approx=False))
    assert np.isin(t.scan_route(queries, limit=32)[0], dead[:10]).any()
    for bad in ([-1], [n]):
        with pytest.raises(ValueError, match="out of range"):
            t.mark_deleted(bad)
    with pytest.raises(RuntimeError, match="build before"):
        _pair(jb, bank)[1].mark_deleted([0])


def test_mesh_packed_scan_matches_unpacked(rng):
    n, d = 1024, 16
    base = _grid(rng.normal(size=(n, d)) * 4)
    queries = _near(rng, base, 6, 0.05)
    jb, bank = _banks(base[:256])
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    ja, a = _pair(jb, bank, 8)
    jp, b = _pair(jb, bank, 8)
    for idx in (ja, a):
        idx.build(base, keep_base=False, keep_bits=True, capacity=n + 64)
    for idx in (jp, b):
        idx.build(base, keep_base=False, keep_bits="packed", capacity=n + 64)
    assert b.bits is None and b.words is not None
    assert b.words[0].dtype == torch.int32
    assert torch.equal(a.popc[0], b.popc[0])
    _assert_state_equal(jp, b)
    ia = a.scan_route(queries, limit=48)
    _assert_same(b.scan_route(queries, limit=48), ia, "packed")
    _assert_same(ia, jp.scan_route(queries, limit=48, approx=False), "JAX")

    dead = np.asarray(ia[0][:, 0][:3], np.int64)
    for idx in (a, b, jp):
        idx.mark_deleted(dead)
    ia = a.scan_route(queries, limit=48)
    _assert_same(b.scan_route(queries, limit=48), ia)
    _assert_same(ia, jp.scan_route(queries, limit=48, approx=False))

    new = _grid(rng.normal(size=(40, d)) * 4)
    _assert_codes_equal(jb, bank, new)
    for idx in (a, b, jp):
        np.testing.assert_array_equal(idx.append_scan_rows(new),
                                      np.arange(n, n + 40))
    qn = new[7:9]
    ia = a.scan_route(qn, limit=48)
    _assert_same(b.scan_route(qn, limit=48), ia)
    _assert_same(ia, jp.scan_route(qn, limit=48, approx=False))
    assert ia[0][0, 0] == n + 7 and ia[0][1, 0] == n + 8
    # chunks smaller than a shard: the loop of the single-device scan
    small = b.scan_route_step_fn_packed(48, chunk=50)(
        b.words, b.popc, b.tombs, torch.from_numpy(qn), b.n)
    _assert_same([x.numpy() for x in small], ia, "chunk 50")


@pytest.mark.parametrize("layout", [True, "packed"])
def test_host_merge_matches_ici_merge(rng, layout):
    n, d, q, L = 1500, 12, 5, 64
    base = _grid(rng.normal(size=(n, d)) * 4)
    queries = _grid(base[:q] + 0.05)
    jb, bank = _banks(base[:512], seed=5)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank)
    for idx in (j, t):
        idx.build(base, keep_base=False, keep_bits=layout, capacity=n + 128)
        idx.mark_deleted(np.arange(0, n, 97))
    ici = t.scan_route(queries, limit=L)
    _assert_same(ici, j.scan_route(queries, limit=L, approx=False), "ici")
    t.merge_backend = j.merge_backend = "host"
    _assert_same(t.scan_route(queries, limit=L), ici, "host vs ici")
    _assert_same(ici, j.scan_route(queries, limit=L, approx=False), "host")
    # the host merge is the JAX package's, carried: same answer on the
    # per-shard blocks of either package
    step = (t.scan_route_step_fn_packed if layout == "packed"
            else t.scan_route_step_fn)(L, merge="host")
    ids, sc = step(t.words if layout == "packed" else t.bits, t.popc,
                   t.tombs, torch.from_numpy(queries), t.n)
    assert len(ids) == 1 and ids[0].shape == (q, 8 * min(L, t.shard_rows))
    _assert_same(tsharded.host_merge_topl(ids, sc, L), ici)


def test_mesh_wide_matches_single_chip():
    rng = np.random.default_rng(9)
    base, queries = _clusters(rng, 2048, 16, 6)
    jb, bank = _banks(base[:300], 24, 3, 2, 2, seed=11)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    j, t = _pair(jb, bank, 4, block=16, wide=True)
    for idx in (j, t):
        idx.build(base, keep_base=False, keep_codes=True, keep_bits=False)
    assert t.table[0].min_key2 is not None and t.n_devices == 4
    _assert_tables_equal(j, t)
    got = t.route(queries, probes=3, refinement_limit=128)
    _assert_same(got, j.route(queries, probes=3, refinement_limit=128))
    assert (got[0] >= 0).any()
    got = t.route(queries, probes=3, refinement_limit=128, rerank_limit=50)
    _assert_same(got, j.route(queries, probes=3, refinement_limit=128,
                              rerank_limit=50))


@pytest.mark.parametrize("nd", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1000 * 8, 1001 * 8 - 5])
def test_sharded_scan_equals_single_device_scan(nd, n):
    """The sharded scan at any shard count == the port's own single-device
    ``hamming_scan.scan`` over the same codes; ``rows`` is a multiple of 8
    (n = 8000, except at 3 shards) and not (n = 8003), packed and unpacked,
    both merges, with tombstones."""
    rng = np.random.default_rng(nd * 10_000 + n)
    d, L = 16, 70
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _near(rng, base, 9)
    _, bank = _banks(base[:512])
    dead = rng.choice(n, 60, replace=False)
    codes = coding.encode(torch.from_numpy(base), bank)[0]
    tomb = torch.zeros(n, dtype=torch.bool)
    tomb[torch.from_numpy(dead)] = True
    qbits = ths.unpack_bits_device(
        coding.encode(torch.from_numpy(queries), bank)[0], bank.code_bits)
    want = ths.scan(ths.build_scan_state(coding.words_to_numpy(codes),
                                         bank.code_bits), qbits, tomb, L)
    want = (want.ids.numpy(), want.scores.numpy())
    for layout in (True, "packed"):
        idx = ShardedIndex(make_mesh(nd, device="cpu"), bank)
        idx.build(base, keep_base=False, keep_bits=layout)
        assert idx.shard_rows == -(-n // nd)
        idx.mark_deleted(dead)
        for merge in ("ici", "host"):
            idx.merge_backend = merge
            _assert_same(idx.scan_route(queries, limit=L), want,
                         (layout, merge))


def test_approx_raises_and_defaults_to_exact(rng):
    """Every sharded scan entry takes ``approx=True`` (its default, as in
    the JAX package; refused before the port had an approximate top-L)
    and, on the CPU, where it selects exactly, returns the route of
    ``approx=False``; nothing raises."""
    base = _grid(rng.normal(size=(256, 8)) * 3)
    _, bank = _banks(base, m=6, lam=2, tables=2, divisions=2)
    n_live = torch.tensor(256)
    for layout in (True, "packed"):
        idx = ShardedIndex(make_mesh(2, device="cpu"), bank)
        idx.build(base, keep_base=False, keep_bits=layout)
        exact = idx.scan_route(base[:2], limit=8, approx=False)
        assert exact[0].shape == (2, 8)
        args = (idx.words if layout == "packed" else idx.bits, idx.popc,
                idx.tombs, idx._queries(base[:2]), int(n_live))
        step = (idx.scan_route_step_fn_packed if layout == "packed"
                else idx.scan_route_step_fn)(8, approx=True)
        for got in (idx.scan_route(base[:2], limit=8),
                    idx.scan_route(base[:2], limit=8, approx=True),
                    idx.scan_route_dispatch(base[:2], limit=8,
                                            approx=True).get(),
                    tuple(x.numpy() for x in step(*args))):
            _assert_same(got, exact, layout)
    bare = ShardedIndex(make_mesh(2, device="cpu"), bank)
    bare.build(base, keep_base=False)
    with pytest.raises(RuntimeError, match="keep_bits"):
        bare.scan_route(base[:2])
    with pytest.raises(RuntimeError, match="keep_base=False"):
        bare.query(base[:2])


def test_make_mesh_and_scan_layout():
    mesh = make_mesh(device="cpu")
    assert mesh.n_shards == 1 and mesh.device == torch.device("cpu")
    assert make_mesh(5, device="cpu").n_shards == 5
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    rl = tsharded.resolve_scan_layout
    assert [rl(m, 10, 10, "cpu") for m in
            (False, None, True, "off", "packed", "on")] == \
        [False, False, True, True, "packed", "packed"]
    # the CPU reports no memory stats: the 4 GiB fallback decides
    assert rl("auto", 1000, 3072, "cpu") is True
    assert rl("auto", 1 << 21, 3072, "cpu") == "packed"
    with pytest.raises(ValueError, match="unknown scan layout"):
        rl("maybe", 1, 1, "cpu")
