"""The port's approximate top-k (fspann_tpu_torch/ops/approx_topk.py), the
counterpart of ``lax.approx_max_k``, on the CPU.

* ``reduction_output_size`` equals XLA's ``ApproxTopKReductionOutputSize``
  (``jax._src.lib._jax.approx_top_k_reduction_output_size``) over a grid.
* The plain twin of the CUDA kernel (``partial_reduce_plain``, which
  ``partial_reduce`` and ``binned_rank_topk`` run on a CPU tensor) equals
  a numpy statement of the definition (element i in bin i mod W, the least
  (value, i) key kept, then the exact top-k of the bins), keeps each bin's
  least key, equals the exact top-k where r == 0, and keeps at least 98% of
  the exact top-2,000 at 1M columns.
* With ``approx=True`` on both sides the port's scan, chunked scan (bits
  and words), re-rank route and sharded scan (1 and 4 shards) equal the
  JAX package's bit for bit: on the CPU XLA sorts and slices, and the port
  selects exactly too.  The limits stay below the row length, where
  XLA:CPU keeps the lower index first among ties (at k equal to the row
  length it sorts without doing so; tests/test_torch_routing.py compares
  that case as sets).

The CUDA kernel against its plain twin: tests/test_torch_approx_topk_cuda.py
(``cuda`` marker) and ``chip_smoke.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src.lib import _jax

from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import hamming_scan as jhs
from fspann_tpu.ops import partition as jpartition
from fspann_tpu.ops import routing as jrouting
from fspann_tpu.parallel.sharded import ShardedIndex as JIndex
from fspann_tpu.parallel.sharded import make_mesh as jmake_mesh
from fspann_tpu_torch.api.convert import bank_from_jax, table_from_jax
from fspann_tpu_torch.ops import approx_topk as at
from fspann_tpu_torch.ops import coding, routing
from fspann_tpu_torch.ops import hamming_scan as ths
from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh

torch.set_num_threads(1)

FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")
GRID_N = (1, 127, 128, 129, 1_000, 4_096, 20_000, 56_000, 100_000, 266_384,
          524_288, 541_248, 1_000_000, 1_065_536, 10_000_000)
GRID_K = (1, 2, 10, 64, 100, 2_000, 4_000, 56_000)


@pytest.mark.parametrize("recall_target", [0.9, 0.95, 0.98, 0.99])
def test_reduction_output_size_matches_xla(recall_target):
    for n in GRID_N:
        for k in GRID_K:
            if k > n:
                continue
            want = tuple(_jax.approx_top_k_reduction_output_size(
                n, 2, k, recall_target, False, -1))
            assert at.reduction_output_size(n, k, recall_target) == want, \
                (n, k)


def test_reduction_output_size_at_the_scan_points():
    """The table of the port's operating points."""
    for n, k, want in ((1_000_000, 2_000, (125_056, 3)),
                       (524_288, 2_000, (131_072, 2)),
                       (475_712, 2_000, (119_040, 2)),
                       (541_248, 2_000, (135_424, 2)),
                       (1_065_536, 2_000, (133_248, 3)),
                       (266_384, 2_000, (133_248, 1)),
                       (20_000, 100, (5_120, 2)),
                       (56_000, 2_000, (56_000, 0))):
        assert at.reduction_output_size(n, k) == want, n
    with pytest.raises(ValueError):
        at.reduction_output_size(1_000, 1_001)


def _numpy_binned(x, k, w, row0=0, popc=None, scale=1, dead=None):
    """The definition, in numpy: rank value, keys, scatter-min into bin
    ``i mod w``, exact top-k of the bins, decoded."""
    q, c = x.shape
    v = scale * x.astype(np.int64)
    if popc is not None:
        v = v + popc
    if dead is not None:
        v = np.where(dead[None, :], 1 << 30, v)
    keys = (v << 32) | (row0 + np.arange(c, dtype=np.int64))
    out = np.empty((q, k), np.int64)
    for qi in range(q):
        best = np.full(w, np.iinfo(np.int64).max)
        np.minimum.at(best, np.arange(c) % w, keys[qi])
        out[qi] = np.sort(best)[:k]
    return (out >> 32).astype(np.int32), (out & 0xFFFFFFFF).astype(np.int32)


@pytest.mark.parametrize("epilogue", ["scan", "rerank"])
def test_binned_matches_numpy_definition(epilogue):
    """N 20,000, k 100 (W 5,120, r 2): few distinct values (long runs of
    ties inside and across bins), dead rows, a row offset."""
    rng = np.random.default_rng(3)
    q, n, k = 5, 20_000, 100
    w, r = at.reduction_output_size(n, k)
    assert (w, r) == (5_120, 2)
    x = rng.integers(0, 40, (q, n)).astype(np.int32)
    x0 = x.copy()
    dead = rng.random(n) < 0.1
    popc = rng.integers(30, 90, n).astype(np.int32)
    kw = dict(popc=popc, scale=-2, dead=dead) if epilogue == "scan" else {}
    row0 = 7_000
    want = _numpy_binned(x, k, w, row0, **kw)
    tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    got = at.binned_rank_topk(torch.from_numpy(x), k, w, r, row0, **tkw)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(x, x0)    # the epilogue leaves x alone


def _numpy_bin_minima(keys, w, off=0):
    """[Q, w] least key of each bin, column i in bin (i + off) mod w."""
    best = np.full((keys.shape[0], w), np.iinfo(np.int64).max)
    for qi in range(keys.shape[0]):
        np.minimum.at(best[qi], (np.arange(keys.shape[1]) + off) % w,
                      keys[qi])
    return best


@pytest.mark.parametrize("left", [60, 3_000, 5_121, 9_000, 19_999])
def test_offset_bins_as_jaxs_whole_block(left):
    """A chunked scan's tail: ``left`` live columns ending a 20,000-column
    block (k 100: W 5,120, r 2) whose front ``20,000 - left`` columns were
    scanned already.  The JAX package bins the whole block with the front
    DEAD; the port bins only the live columns, at ``off = 20,000 - left``.
    Every bin that holds a live element keeps JAX's key, every other bin is
    dead in both, and the selections agree once dead entries read (_DEAD,
    -1), as the scan's merge reads them; the port's empty bins (INT64_MAX)
    decode to (_DEAD, -1) by themselves."""
    rng = np.random.default_rng(left)
    q, chunk, k = 4, 20_000, 100
    w, r = at.reduction_output_size(chunk, k)
    assert (w, r) == (5_120, 2)
    off = chunk - left
    start_c = 30_000
    x = rng.integers(0, 40, (q, chunk)).astype(np.int32)
    popc = rng.integers(30, 90, chunk).astype(np.int32)
    dead = rng.random(chunk) < 0.1
    front = np.arange(chunk) < off
    v = np.where((dead | front)[None, :], at._DEAD,
                 popc - 2 * x.astype(np.int64))
    jax_bins = _numpy_bin_minima(
        (v << 32) | (start_c + np.arange(chunk)), w)
    live = torch.from_numpy(x[:, off:])
    tkw = dict(popc=torch.from_numpy(popc[off:]), scale=-2,
               dead=torch.from_numpy(dead[off:]))
    bins = at.partial_reduce_plain(live, w, r, start_c + off, off=off,
                                   **tkw).numpy()
    has_live = (jax_bins >> 32) < at._DEAD
    np.testing.assert_array_equal(bins[has_live], jax_bins[has_live])
    assert ((bins[~has_live] >> 32) >= at._DEAD).all()
    want = np.sort(jax_bins, axis=1)[:, :k]
    wv, wi = (want >> 32).astype(np.int32), (want & 0xFFFFFFFF) \
        .astype(np.int32)
    gv, gi = at.binned_rank_topk(live, k, w, r, start_c + off, off=off,
                                 **tkw)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(
        torch.where(gv < at._DEAD, gi, -1).numpy(),
        np.where(wv < at._DEAD, wi, -1))
    if left < k:
        assert (gv[:, left:] == at._DEAD).all() and (gi[:, left:] == -1).all()


def test_partial_reduce_keeps_each_bins_least_key():
    """Equal values keep the bin's lowest index; a lower value later in the
    bin wins; a bin whose live element is its last keeps that one; a bin
    past the columns holds INT64_MAX."""
    w, r, c = 128, 2, 3 * 128 + 5
    x = torch.full((2, c), 7, dtype=torch.int32)
    x[1, 2 * w + 3] = 2                     # row 1, bin 3: the third element
    dead = torch.zeros(c, dtype=torch.bool)
    dead[[10, 10 + w]] = True               # bin 10 keeps element 10 + 2w
    got = at.partial_reduce(x, w, r, 0, dead=dead)
    assert got.shape == (2, w) and got.dtype == torch.int64
    cols = torch.arange(w, dtype=torch.int64)
    want = (torch.tensor(7, dtype=torch.int64) << 32) | cols
    want[10] = (7 << 32) | (10 + 2 * w)
    assert torch.equal(got[0], want)
    want[3] = (2 << 32) | (2 * w + 3)
    assert torch.equal(got[1], want)
    # 4 x 128 bins over 300 columns: bins 300.. hold nothing
    sparse = at.partial_reduce_plain(x[:, :300], w * 4, 0)
    assert (sparse[:, 300:] == at.INT64_MAX).all()
    assert torch.equal(sparse[:, :300] & 0xFFFFFFFF,
                       torch.arange(300).expand(2, 300))


@pytest.mark.parametrize("n,k", [(56_000, 2_000), (1_000, 64), (120, 7)])
def test_plain_twin_is_exact_where_nothing_is_reduced(n, k):
    """r == 0: the binned selection over W == n bins, and approx_rank_topk
    on any device, equal _rank_topk."""
    rng = np.random.default_rng(n)
    part = torch.from_numpy(rng.integers(-50, 50, (3, n)).astype(np.int32))
    w, r = at.reduction_output_size(n, k)
    assert (w, r) == (n, 0)
    want = ths._rank_topk(part, k, 11)
    for got in (at.binned_rank_topk(part, k, w, r, 11),
                at.approx_rank_topk(part, k, 11)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_selection_is_exact_where_the_card_reduces():
    """On a CPU tensor approx_rank_topk is the exact top-k, as XLA:CPU's
    approx_max_k is, even where r > 0."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 3_000, (4, 20_000)).astype(np.int32))
    popc = torch.from_numpy(rng.integers(0, 3_000, 20_000).astype(np.int32))
    dead = torch.from_numpy(rng.random(20_000) < 0.05)
    got = at.approx_rank_topk(x, 100, 5, popc=popc, scale=-2, dead=dead)
    part = (x * -2 + popc).masked_fill(dead[None, :], at._DEAD)
    want = ths._rank_topk(part, 100, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_binned_keeps_the_exact_top_2000_at_1m():
    """[8, 1,000,000] Hamming-range scores (popc - 2 dot of random
    3,072-bit codes), L = 2,000: the binned selection (W 125,056, r 3)
    keeps a mean share >= 0.98 of the exact (score, id) top-2,000; about
    (k - 1) / (2 W) = 0.8% is expected to collide."""
    rng = np.random.default_rng(21)
    q, n, k = 8, 1_000_000, 2_000
    dots = torch.from_numpy(rng.binomial(768, 0.5, (q, n)).astype(np.int32))
    popc = torch.from_numpy(rng.binomial(3_072, 0.5, n).astype(np.int32))
    w, r = at.reduction_output_size(n, k)
    got = at.binned_rank_topk(dots, k, w, r, popc=popc, scale=-2)[1]
    want = at.approx_rank_topk(dots, k, popc=popc, scale=-2)[1]   # exact
    share = [len(np.intersect1d(g, e)) / k
             for g, e in zip(got.numpy(), want.numpy())]
    assert np.mean(share) >= 0.98, share
    assert min(share) < 1.0            # the reduction did drop some


def test_partial_reduce_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 300), dtype=torch.int32)
    with pytest.raises(TypeError):
        at.partial_reduce(x.long(), 128, 2)
    with pytest.raises(ValueError, match="popc"):
        at.partial_reduce(x, 128, 2, popc=torch.zeros(299, dtype=torch.int32))
    with pytest.raises(ValueError, match="dead"):
        at.partial_reduce(x, 128, 2, dead=torch.zeros(300, dtype=torch.int8))
    with pytest.raises(ValueError, match="bins"):
        at.partial_reduce(x, 128, 1)
    with pytest.raises(ValueError, match="bins"):
        at.partial_reduce(x, 128, 2, off=213)
    assert at.partial_reduce.launches == 0        # the CPU launches nothing


# ---- the scan paths against the JAX package, approx=True on both sides ----

def _codes(rng, n, nq, d=24):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = rng.normal(size=(nq, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], 10, 2, 2, 2, 3)
    codes, _ = coding.encode_numpy(base, bank)
    qcodes, _ = coding.encode_numpy(queries, bank)
    return codes, ths.unpack_bits_numpy(qcodes, bank.code_bits), \
        bank.code_bits


def _assert_same(j, t):
    for f in FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)


@pytest.mark.parametrize("nq", [1, 7, 64])
def test_scan_approx_matches_jax(rng, nq):
    codes, qbits, cb = _codes(rng, 900, nq)
    tomb = rng.random(900) < 0.05
    kw = dict(anchor=10, margin=6)
    j = jhs.scan(jhs.build_scan_state(codes, cb), jnp.asarray(qbits),
                 jnp.asarray(tomb), 200, approx=True, **kw)
    t = ths.scan(ths.build_scan_state(codes, cb), torch.from_numpy(qbits),
                 torch.from_numpy(tomb), 200, approx=True, **kw)
    _assert_same(j, t)


@pytest.mark.parametrize("packed", [False, True], ids=["bits", "words"])
@pytest.mark.parametrize("n,chunk", [(1_000, 256), (1_000, 300),
                                     (700, 1_024)])
def test_scan_chunked_approx_matches_jax(rng, packed, n, chunk):
    """Full chunks, a ragged tail (the port's tail block is the rows that
    are left, JAX's re-reads) and the n <= chunk fall-through."""
    codes, qbits, cb = _codes(rng, n, 5)
    tomb = rng.random(n) < 0.05
    kw = dict(anchor=10, margin=8)
    if packed:
        jst, tst = (jhs.build_scan_state_packed(codes, cb),
                    ths.build_scan_state_packed(codes, cb))
        kw["code_bits"] = cb
    else:
        jst, tst = jhs.build_scan_state(codes, cb), ths.build_scan_state(
            codes, cb)
    j = jhs.scan_chunked(jst, jnp.asarray(qbits), jnp.asarray(tomb), 60,
                         chunk=chunk, approx=True, **kw)
    t = ths.scan_chunked(tst, torch.from_numpy(qbits), torch.from_numpy(tomb),
                         60, chunk=chunk, approx=True, **kw)
    _assert_same(j, t)


def test_route_rerank_approx_matches_jax(rng):
    n, d = 600, 24
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    jb = jcoding.build_bank_from_sample(base[:256], 10, 2, 2, 2, 3)
    codes, keys = jcoding.encode_numpy(base, jb)
    jt = jpartition.build_partitions(
        jnp.asarray(np.ascontiguousarray(keys.T)),
        jnp.asarray(np.ascontiguousarray(codes.transpose(1, 0, 2))), 16)
    qc, qk = jcoding.encode_numpy(
        base[:6] + rng.normal(size=(6, d)).astype(np.float32), jb)
    tomb = rng.random(n) < 0.1
    want = jrouting.route_rerank(jt, jnp.asarray(qc), jnp.asarray(qk),
                                 jnp.asarray(tomb), jnp.asarray(codes), 4, 50,
                                 approx=True)
    got = routing.route_rerank(table_from_jax(jt), coding.words_to_torch(qc),
                               torch.from_numpy(qk), torch.from_numpy(tomb),
                               coding.words_to_torch(codes), 4, 50,
                               approx=True)
    for f in ("ids", "scores", "n_unique", "n_raw"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _grid(x):
    return (np.round(np.asarray(x, np.float64) * 16) / 16).astype(np.float32)


@pytest.mark.parametrize("nd", [1, 4])
@pytest.mark.parametrize("layout", [True, "packed"])
def test_sharded_scan_route_approx_matches_jax(nd, layout):
    """Vectors on the 1/16 grid and ``alpha`` on the 2^-10 grid, so both
    device encoders are exact (tests/test_torch_sharded.py); each merge."""
    rng = np.random.default_rng(40 + nd)
    n, d = 1_200, 16
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(base[:5] + rng.normal(size=(5, d)) * 0.1)
    jb = jcoding.build_bank_from_sample(base[:512], 8, 2, 3, 2, 13)
    alpha = (np.round(np.asarray(jb.alpha, np.float64) * 1024) / 1024) \
        .astype(np.float32)
    jb = dataclasses.replace(jb, alpha=alpha)
    bank = bank_from_jax(alpha, np.asarray(jb.r), np.asarray(jb.omega), jb.m,
                         jb.lam, jb.tables, jb.divisions, jb.seed)
    j = JIndex(jmake_mesh(nd), jb)
    t = ShardedIndex(make_mesh(nd, device="cpu"), bank)
    dead = rng.choice(n, 40, replace=False)
    for idx in (j, t):
        idx.build(base, keep_base=False, keep_bits=layout)
        idx.mark_deleted(dead)
    for merge in ("ici", "host"):
        j.merge_backend = t.merge_backend = merge
        got = t.scan_route(queries, limit=90, approx=True)
        want = j.scan_route(queries, limit=90, approx=True)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=merge)
        assert not np.isin(got[0], dead).any()
