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


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,q,k", [(700, 16, 4, 10), (5000, 128, 70, 100),
                                     (20_000, 960, 33, 128)])
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
    ids, p_ids = ids.cpu().numpy(), p_ids.cpu().numpy()
    for i in range(q):
        assert len(set(ids[i].tolist())) == k
        untied = np.abs(np.diff(p_dist[i])) > ATOL + RTOL * p_dist[i][1:]
        keep = np.concatenate([[True], untied]) & np.concatenate([untied,
                                                                  [True]])
        np.testing.assert_array_equal(ids[i][keep], p_ids[i][keep])


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
