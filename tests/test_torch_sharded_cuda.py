"""The sharded index on a CUDA device against the same index on the CPU, at
100k rows of 3,072-bit codes (24 groups x 128 bits): build, scan route
(packed and unpacked, both merges, 1, 4 and 8 shards), probe route with the
full-code re-rank (one ``code_hamming`` launch per shard) and live insert.
Every integer output must be equal bit for bit.  The scan routes compared
pass ``approx=False``: the default (approximate) selection runs the
``approx_topk`` kernel on the card and selects exactly on the CPU
(tests/test_torch_approx_topk_cuda.py holds it to its plain twin).

Both devices ENCODE here, so the inputs sit on the exact grid of
tests/test_torch_sharded.py (vectors multiples of 1/16, ``alpha`` multiples
of 2^-10: every float32 projection is exact whatever the order of its sum),
which makes the codes equal by construction; the test asserts it.

No top-level jax import: on a GPU host these run with
``python -m pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py``
and skip where there is no CUDA device."""

import dataclasses

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops.code_hamming import code_hamming
from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh

N, D, NQ, L = 100_000, 32, 64, 2000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grid(x):
    return (np.round(np.asarray(x, np.float64) * 16) / 16).astype(np.float32)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    base = _grid(rng.normal(size=(N, D)) * 2)
    queries = _grid(base[rng.integers(0, N, NQ)]
                    + rng.normal(size=(NQ, D)) * 0.3)
    bank = coding.build_bank_from_sample(base[:1000], 64, 2, 8, 3, 13)
    bank = dataclasses.replace(bank, alpha=(np.round(
        bank.alpha.astype(np.float64) * 1024) / 1024).astype(np.float32))
    dead = rng.choice(N, 1000, replace=False)
    return base, queries, bank, dead


def _same(got, want, what):
    for g, w, name in zip(got, want, ("ids", "scores")):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [1, 4, 8])
def test_sharded_scan_cuda_matches_cpu(cuda, nd):
    base, queries, bank, dead = _inputs()
    assert bank.g * bank.code_bits == 3072
    for layout in (True, "packed"):
        pair = []
        for dev in ("cpu", cuda):
            idx = ShardedIndex(make_mesh(nd, device=dev), bank, block_size=128)
            idx.build(base, keep_base=False, keep_codes=True,
                      keep_bits=layout, capacity=N + 4096)
            idx.mark_deleted(dead)
            pair.append(idx)
        host, card = pair
        state = card.words if layout == "packed" else card.bits
        assert state[0].is_cuda and card.popc[0].is_cuda \
            and card.tombs[0].is_cuda
        assert np.array_equal(host._gather_host(host.point_codes),
                              card._gather_host(card.point_codes)), "codes"
        assert torch.equal(host.popc[0], card.popc[0].cpu())
        for f in host.table[0]._fields:
            a, b = getattr(host.table[0], f), getattr(card.table[0], f)
            assert (a is None and b is None) or torch.equal(a, b.cpu()), f
        exact = dict(limit=L, approx=False)
        want = host.scan_route(queries, **exact)
        for merge in ("ici", "host"):
            host.merge_backend = card.merge_backend = merge
            _same(card.scan_route(queries, **exact), want,
                  (nd, layout, merge))
            _same(host.scan_route(queries, **exact), want,
                  (nd, layout, merge, "cpu"))
        for q in (7, 1):
            _same(card.scan_route(queries[:q], **exact),
                  host.scan_route(queries[:q], **exact), (nd, layout, q))
        if layout is True:
            before = code_hamming.launches
            got = card.route(queries, probes=4, refinement_limit=4096,
                             rerank_limit=500)
            assert code_hamming.launches == before + nd
            _same(got, host.route(queries, probes=4, refinement_limit=4096,
                                  rerank_limit=500), (nd, "rerank route"))
            _same(card.route(queries, probes=4, refinement_limit=4096),
                  host.route(queries, probes=4, refinement_limit=4096),
                  (nd, "route"))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [True, "packed"])
def test_append_scan_rows_keeps_storage_on_cuda(cuda, layout):
    base, queries, bank, _ = _inputs(seed=5)
    n0 = N - 20_000
    pair = []
    for dev in ("cpu", cuda):
        idx = ShardedIndex(make_mesh(4, device=dev), bank, block_size=128)
        idx.build(base[:n0], keep_base=False, keep_bits=layout, capacity=N)
        pair.append(idx)
    host, card = pair
    state = (card.words if layout == "packed" else card.bits)[0]
    ptrs = (state.data_ptr(), card.popc[0].data_ptr(),
            card.tombs[0].data_ptr(), tuple(state.shape))
    for lo in range(n0, N, 5000):       # 4 inserts, crossing a shard edge
        for idx in pair:
            ids = idx.append_scan_rows(base[lo:lo + 5000])
            np.testing.assert_array_equal(ids, np.arange(lo, lo + 5000))
    card.mark_deleted([3, N - 1])
    host.mark_deleted([3, N - 1])
    state = (card.words if layout == "packed" else card.bits)[0]
    assert (state.data_ptr(), card.popc[0].data_ptr(),
            card.tombs[0].data_ptr(), tuple(state.shape)) == ptrs, \
        "the insert moved the scan state"
    got = card.scan_route(base[N - 64:N], limit=100, approx=False)
    _same(got, host.scan_route(base[N - 64:N], limit=100, approx=False),
          "after insert")
    own = np.arange(N - 64, N)
    assert (got[0][:-1, 0] == own[:-1]).all()       # self search
    assert N - 1 not in got[0]
    with pytest.raises(RuntimeError, match="capacity"):
        card.append_scan_rows(base[:1])
