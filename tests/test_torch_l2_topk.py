"""Port's L2 top-k (ops/l2_topk + ops/refine.bruteforce_topk) against the JAX
package's bitonic Pallas kernel (interpret mode) and XLA brute force.

On the CPU ``l2_topk`` runs its plain torch twin; the CUDA kernel itself is
held to that twin by the ``cuda``-marked test (and by ``chip_smoke.py``).
Tolerance: rtol 2e-4 / atol 1e-4 on L2 distances, the one
tests/test_pallas_topk.py uses (float32 ``|b|² − 2q·b + |q|²`` summed in a
different order).

The JAX references are imported inside the tests that use them, so the
``cuda``-marked tests also run on a GPU host without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import l2_topk as l2
from fspann_tpu_torch.ops import refine

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


@pytest.mark.parametrize("n,d,q,k", [(700, 16, 4, 10), (1024, 24, 3, 100)])
def test_l2_topk_matches_jax_kernel_and_bruteforce(rng, n, d, q, k):
    from fspann_tpu.ops import refine as jax_refine
    from fspann_tpu.ops.pallas_topk import bitonic_topk

    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    ids, dist = l2.l2_topk(_t(base), _t(queries), k)
    assert ids.dtype == torch.int32 and dist.dtype == torch.float32
    assert tuple(ids.shape) == (q, k) and tuple(dist.shape) == (q, k)
    j_ids, j_dist = bitonic_topk(base, queries, k, tile_n=256, q_tile=8,
                                 interpret=True)
    x_ids, x_dist = jax_refine.bruteforce_topk(base, queries, k)
    np.testing.assert_allclose(dist.numpy(), j_dist, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dist.numpy(), x_dist, rtol=RTOL, atol=ATOL)
    ids = ids.numpy()
    for i in range(q):
        # ids may differ from JAX's only at distance ties: the true
        # distances of the port's ids are the same multiset
        d_true = np.linalg.norm(base[ids[i]] - queries[i], axis=1)
        np.testing.assert_allclose(np.sort(d_true), np.sort(x_dist[i]),
                                   rtol=RTOL, atol=ATOL)
        untied = np.abs(np.diff(x_dist[i])) > ATOL + RTOL * x_dist[i][1:]
        keep = np.concatenate([[True], untied]) & np.concatenate([untied,
                                                                  [True]])
        np.testing.assert_array_equal(ids[i][keep], x_ids[i][keep])


def test_l2_topk_exact_duplicates(rng):
    """Duplicate rows tie in distance; the (d², id) order must keep
    distinct ids rather than duplicating one."""
    from fspann_tpu.ops.pallas_topk import bitonic_topk

    base = np.concatenate([rng.normal(size=(50, 8)).astype(np.float32)] * 4)
    ids, dist = l2.l2_topk(_t(base), _t(base[:3]), 8)
    for row in ids.numpy():
        assert len(set(row.tolist())) == len(row)
    # ties resolve to the lower id, like the kernel's index tie-break
    assert (ids.numpy()[:, :4] == np.arange(3)[:, None]
            + 50 * np.arange(4)[None, :]).all()
    j_ids, j_dist = bitonic_topk(base, base[:3], 8, tile_n=256, q_tile=8,
                                 interpret=True)
    np.testing.assert_allclose(dist.numpy(), j_dist, rtol=RTOL, atol=5e-3)
    np.testing.assert_allclose(dist.numpy()[:, :4], 0.0, atol=5e-3)


def test_l2_topk_ragged_edge(rng):
    """A base that fills no tile evenly: no padding row may surface."""
    from fspann_tpu.ops.pallas_topk import bitonic_topk

    base = rng.normal(size=(300, 12)).astype(np.float32)
    ids, dist = l2.l2_topk(_t(base), _t(base[:3]), 5)
    ids = ids.numpy()
    assert (ids < 300).all() and (ids >= 0).all()
    assert (ids[:, 0] == np.arange(3)).all()
    j_ids, _ = bitonic_topk(base, base[:3], 5, tile_n=256, q_tile=8,
                            interpret=True)
    np.testing.assert_array_equal(ids[:, 0], j_ids[:, 0])


def test_bruteforce_chunk_merge_equals_one_chunk(rng):
    """The chunked merge gives the one-chunk answer exactly, ids and
    distances, including (d², id) ties across chunk boundaries (small
    integer coordinates: every product is exact, so ties are exact)."""
    base = np.repeat(rng.integers(-8, 9, size=(90, 6)), 3, axis=0) \
        .astype(np.float32)
    queries = rng.integers(-8, 9, size=(5, 6)).astype(np.float32)
    a_ids, a_d = refine.bruteforce_topk(base, _t(queries), 40, chunk=37)
    b_ids, b_d = refine.bruteforce_topk(base, _t(queries), 40)
    assert torch.equal(a_ids, b_ids) and torch.equal(a_d, b_d)


def test_l2_topk_rejects_what_the_kernel_does_not_take():
    base = torch.zeros((200, 8))
    with pytest.raises(ValueError):
        l2.l2_topk(base, torch.zeros((2, 8)), l2.MAX_K + 1)
    with pytest.raises(ValueError):
        l2.l2_topk(torch.zeros((200, l2.MAX_D + 1)),
                   torch.zeros((2, l2.MAX_D + 1)), 4)
    with pytest.raises(TypeError):
        l2.l2_topk(base.double(), torch.zeros((2, 8), dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        l2.l2_topk(base, torch.zeros((2, 9)), 4)


def _tf32(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    """float32 cut to TF32's 10 mantissa bits: rounded to nearest (half an
    ulp added to the magnitude, as the kernel forms ``hi``) or truncated (as
    the tensor core reads ``lo``)."""
    b = x.contiguous().view(torch.int32)
    return ((b + (0x1000 if rounded else 0)) & ~0x1FFF).view(torch.float32)


def _split_tf32_topk(base, queries, k, one_pass=False):
    """The CUDA kernel's arithmetic in torch: q.b = lo.hi + hi.lo + hi.hi
    over TF32 halves (hi.hi alone with ``one_pass``, the control build),
    float32 sums, |b|^2 exact in float32, then the (|b|^2 - 2 q.b, row)
    order."""
    b, q = _t(base), _t(queries)
    bh, qh = _tf32(b, True), _tf32(q, True)
    bl, ql = _tf32(b - bh, False), _tf32(q - qh, False)
    dot = qh @ bh.T if one_pass else ql @ bh.T + qh @ bl.T + qh @ bh.T
    score = (b * b).sum(dim=1)[None, :] - 2.0 * dot
    order = torch.sort(score, dim=1, stable=True).indices[:, :k]
    v = torch.gather(score, 1, order)
    dist = torch.sqrt(torch.clamp(v + (q * q).sum(dim=1)[:, None], min=0.0))
    return order.numpy(), dist.numpy()


@pytest.mark.parametrize("d", [16, 128, 960])
def test_split_tf32_product_matches_jax_within_tolerance(rng, d):
    """The kernel's split-TF32 product, emulated here, holds the same
    tolerance against JAX's brute force and Pallas kernel as float32 does;
    ids differ only at ties."""
    from fspann_tpu.ops import refine as jax_refine
    from fspann_tpu.ops.pallas_topk import bitonic_topk

    n, q, k = 600, 5, 50
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    ids, dist = _split_tf32_topk(base, queries, k)
    j_ids, j_dist = bitonic_topk(base, queries, k, tile_n=256, q_tile=8,
                                 interpret=True)
    x_ids, x_dist = jax_refine.bruteforce_topk(base, queries, k)
    np.testing.assert_allclose(dist, j_dist, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dist, x_dist, rtol=RTOL, atol=ATOL)
    # float32-level agreement, far inside the tolerance (one TF32 pass
    # keeps about three digits and is not)
    assert np.abs(dist - x_dist).max() <= 1e-5 * x_dist.max()
    for i in range(q):
        untied = np.abs(np.diff(x_dist[i])) > ATOL + RTOL * x_dist[i][1:]
        keep = np.concatenate([[True], untied]) & np.concatenate([untied,
                                                                  [True]])
        np.testing.assert_array_equal(ids[i][keep], np.asarray(x_ids)[i][keep])
        np.testing.assert_array_equal(ids[i][keep], np.asarray(j_ids)[i][keep])


@pytest.mark.parametrize("d", [16, 128, 960])
def test_f32_error_limit_separates_split_from_one_tf32_pass(rng, d):
    """``F32_ERROR_LIMIT`` passes the split-TF32 product and float32, and
    fails one TF32 pass, on the emulated arithmetic (the chip's readings:
    scripts/torch_l2_topk_precision.py)."""
    n, q, k = 2000, 64, 100
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)

    def err(ids, dist):
        return l2.float64_error(_t(base), _t(queries),
                                torch.from_numpy(np.asarray(ids)),
                                torch.from_numpy(np.asarray(dist)))

    assert err(*_split_tf32_topk(base, queries, k)) <= l2.F32_ERROR_LIMIT
    assert err(*refine.bruteforce_topk(base, _t(queries), k)) \
        <= l2.F32_ERROR_LIMIT
    assert err(*_split_tf32_topk(base, queries, k, one_pass=True)) \
        > l2.F32_ERROR_LIMIT


@pytest.mark.parametrize("n,nq", [(1_000_000, 1024), (262_144, 256),
                                  (262_144, 129), (1_000_000, 1),
                                  (5_000_000, 2048)])
def test_launch_geometry_whole_waves(n, nq):
    """Every row lies in exactly one split, every split holds a row, and the
    grid is whole waves of ``RESIDENT`` blocks on each of 132 SMs."""
    rows, splits = l2._splits(n, nq, 132)
    starts = np.arange(splits) * rows
    assert starts[-1] < n <= starts[-1] + rows
    owner = np.minimum(np.arange(n) // rows, splits - 1)
    assert np.array_equal(np.bincount(owner, minlength=splits),
                          np.minimum(rows, n - starts))
    assert rows >= l2.MIN_ROWS
    blocks = -(-nq // l2.QT) * splits
    assert blocks % (132 * l2.RESIDENT) == 0
    assert blocks <= l2.MAX_WAVES * 132 * l2.RESIDENT


@pytest.mark.parametrize("n,nq", [(20_000, 33), (700, 4), (100, 1)])
def test_launch_geometry_small_grid_fits_one_wave(n, nq):
    """Where the whole grid fits one wave it takes every split that leaves
    ``MIN_ROWS`` rows to each (at least one split)."""
    rows, splits = l2._splits(n, nq, 132)
    assert splits == max(1, n // l2.MIN_ROWS)
    assert (splits - 1) * rows < n <= splits * rows
    assert -(-nq // l2.QT) * splits <= 132 * l2.RESIDENT


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,q,k", [
    (700, 12, 1, 1),              # one query, k = 1
    (5000, 100, 63, 100),         # one query short of the 64-query tile
    (20_001, 960, 65, 128),       # the widest vectors, k = MAX_K
    (130_001, 128, 129, 100),     # many splits; rows not a multiple of 128
    (3001, 13, 64, 10),           # d % 4 != 0: 4-byte copies
    (128, 12, 65, 128),           # n == k
    (100, 16, 3, 100),            # n == k, one split shorter than a tile
])
def test_l2_topk_cuda_kernel_matches_plain(n, d, q, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(n)
    base = _t(rng.normal(size=(n, d))).cuda()
    queries = _t(rng.normal(size=(q, d))).cuda()
    before = l2.l2_topk.launches
    ids, dist = l2.l2_topk(base, queries, k)
    assert l2.l2_topk.launches == before + 1
    p_ids, p_dist = refine.bruteforce_topk(base, queries, k)
    torch.cuda.synchronize()
    p_dist = p_dist.cpu().numpy()
    np.testing.assert_allclose(dist.cpu().numpy(), p_dist, rtol=RTOL,
                               atol=ATOL)
    # float32-accurate: one TF32 pass passes the tolerance above, not this
    assert l2.float64_error(base, queries, ids, dist) <= l2.F32_ERROR_LIMIT
    ids, p_ids = ids.cpu().numpy(), p_ids.cpu().numpy()
    for i in range(q):
        assert len(set(ids[i].tolist())) == k
        assert ((ids[i] >= 0) & (ids[i] < n)).all()
        untied = np.abs(np.diff(p_dist[i])) > ATOL + RTOL * p_dist[i][1:]
        keep = np.concatenate([[True], untied]) & np.concatenate([untied,
                                                                  [True]])
        np.testing.assert_array_equal(ids[i][keep], p_ids[i][keep])


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,k", [
    (1500, 128, 1),               # one split; buffers fill to CAP
    (2000, 64, 100),              # one split, one query tile
    (30_000, 129, 128),           # 29 splits, 3 query tiles, k = MAX_K
])
def test_l2_topk_cuda_kernel_every_row_admitted(n, q, k):
    """Scores that fall with the row inside each split, for every query:
    each tile beats the running K-th, so every row of every tile is
    admitted and the admission buffers fill as fast as they can.  Small
    integer coordinates make every score exact (TF32 halves included), so
    ids and distances equal the plain twin's, ties broken by the row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rows, _ = l2._splits(
        n, q, torch.cuda.get_device_properties(0).multi_processor_count)
    d = 16
    base = np.zeros((n, d), np.float32)
    base[:, 0] = np.arange(n) % rows + 1        # rises inside each split
    queries = np.zeros((q, d), np.float32)
    queries[:, 0] = rows + 1 + np.arange(q)     # above every row: |b|^2 -
    # 2 q.b = c^2 - 2 s c falls as c rises, and stays below 2^24
    ids, dist = l2.l2_topk(_t(base).cuda(), _t(queries).cuda(), k)
    p_ids, p_dist = refine.bruteforce_topk(_t(base).cuda(),
                                           _t(queries).cuda(), k)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(ids.cpu().numpy(), p_ids.cpu().numpy())
    np.testing.assert_array_equal(dist.cpu().numpy(), p_dist.cpu().numpy())
    # the nearest row is the highest offset of a split, the first such
    assert (ids.cpu().numpy()[:, 0] == rows - 1).all()


def _wide_rows(kind):
    """Rows of d = 960 whose products pile up one way: 100,000 rows of the
    clustered corpus (the 960-d point's generator), or coordinates near 1
    (every product positive)."""
    if kind == "clustered":
        from fspann_tpu_torch.io import synthetic
        return synthetic.lsh_hard_corpus(100_000, 960, 64, seed=42)
    rng = np.random.default_rng(9)
    return tuple((1 + 0.01 * rng.normal(size=(n, 960))).astype(np.float32)
                 for n in (20_000, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["clustered", "positive"])
def test_l2_topk_cuda_float32_accurate_where_products_pile_up(kind):
    """A running tensor-core accumulator carried through all 120 k-steps of
    d = 960 truncates its way past F32_ERROR_LIMIT on such rows (1M x 960,
    chip_smoke.py phase 18: 9.5e-6); each k-step's products summed apart
    and added in float32 stay within it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    base, queries = (_t(x).cuda() for x in _wide_rows(kind))
    ids, dist = l2.l2_topk(base, queries, 100)
    assert l2.float64_error(base, queries, ids, dist) <= l2.F32_ERROR_LIMIT


@pytest.mark.cuda
def test_l2_topk_cuda_resident_blocks():
    """The launch geometry assumes ``RESIDENT`` blocks of pass 1 per SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert l2.blocks_per_sm() == l2.RESIDENT


@pytest.mark.cuda
def test_l2_topk_cuda_kernel_exact_duplicates():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    base = np.concatenate([rng.normal(size=(50, 8)).astype(np.float32)] * 4)
    ids, dist = l2.l2_topk(_t(base).cuda(), _t(base[:3]).cuda(), 8)
    ids = ids.cpu().numpy()
    for row in ids:
        assert len(set(row.tolist())) == len(row)
    assert (ids[:, :4] == np.arange(3)[:, None]
            + 50 * np.arange(4)[None, :]).all()
    np.testing.assert_allclose(dist.cpu().numpy()[:, :4], 0.0, atol=5e-3)
