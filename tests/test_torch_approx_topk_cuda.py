"""The approximate top-k kernel (fspann_tpu_torch/csrc/approx_topk.cu) against
its plain torch twin on the card, bit for bit.  Every test needs a CUDA
device and skips without one; no jax here, so on a GPU host:

    python -m pytest --noconftest -m cuda tests/test_torch_approx_topk_cuda.py
"""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import approx_topk as at
from fspann_tpu_torch.ops import hamming_scan as ths

# (Q, C, k): small shapes at the kernel's edges (r 1, a ragged last step,
# W one tile, k = 1) and the scan's bench shapes: the flat scan at 1M (r 3),
# a full chunk and a 475,712-row slice (r 2), a 4-shard slice (r 1)
SHAPES = [(3, 1_000, 10), (7, 20_000, 100), (1, 129, 1), (2, 257, 1),
          (64, 1_000_000, 2_000), (64, 524_288, 2_000),
          (7, 475_712, 2_000), (1, 266_384, 2_000)]
# (Q, C, width, k): C columns ending a width-column block, binned as the
# block: the 1M chunked scan's tail in its 2^19-row chunk (off 48,576), an
# offset past one bin row, the least and the largest tail that bins
OFFSETS = [(7, 475_712, 524_288, 2_000), (3, 700, 1_024, 10),
           (2, 5_121, 20_000, 100), (1, 19_999, 20_000, 100)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(q, c, seed):
    """int32 bit products in the scan's range, popcounts, 1% dead rows."""
    g = torch.Generator().manual_seed(seed)
    dots = torch.randint(0, 1_536, (q, c), generator=g, dtype=torch.int32)
    popc = torch.randint(1_200, 1_900, (c,), generator=g, dtype=torch.int32)
    dead = torch.rand(c, generator=g) < 0.01
    return dots, popc, dead


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,k", SHAPES)
def test_partial_reduce_kernel_matches_plain(q, c, k):
    dev = _cuda()
    dots, popc, dead = (t.to(dev) for t in _inputs(q, c, c + q))
    w, r = at.reduction_output_size(c, k)
    assert r > 0
    for row0, kw in ((0, dict(popc=popc, scale=-2, dead=dead)),
                     (12_345, {})):
        before = at.partial_reduce.launches
        got = at.partial_reduce(dots, w, r, row0, **kw)
        torch.cuda.synchronize()
        assert at.partial_reduce.launches == before + 1
        want = at.partial_reduce_plain(dots, w, r, row0, **kw)
        assert torch.equal(got, want), (q, c, row0)
        sel = at.approx_rank_topk(dots, k, row0, **kw)
        plain = at._smallest(want, k)
        assert all(torch.equal(a, b) for a, b in zip(sel, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,width,k", OFFSETS)
def test_partial_reduce_kernel_with_offset_matches_plain(q, c, width, k):
    dev = _cuda()
    dots, popc, dead = (t.to(dev) for t in _inputs(q, c, c + width))
    w, r = at.reduction_output_size(width, k)
    off = width - c
    assert r > 0 and c > w
    got = at.partial_reduce(dots, w, r, 777, popc, -2, dead, off)
    want = at.partial_reduce_plain(dots, w, r, 777, popc, -2, dead, off)
    assert torch.equal(got, want)
    before = at.partial_reduce.launches
    sel = at.approx_rank_topk(dots, k, 777, popc=popc, scale=-2, dead=dead,
                              width=width)
    assert at.partial_reduce.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(sel, at._smallest(want, k)))


@pytest.mark.cuda
def test_no_reduction_equals_rank_topk_on_the_card():
    dev = _cuda()
    dots, popc, dead = (t.to(dev) for t in _inputs(64, 56_000, 5))
    before = at.partial_reduce.launches
    got = at.approx_rank_topk(dots, 2_000, popc=popc, scale=-2, dead=dead)
    assert at.partial_reduce.launches == before      # r == 0: no kernel
    part = (dots * -2 + popc).masked_fill(dead[None, :], at._DEAD)
    want = ths._rank_topk(part, 2_000)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_scan_approx_on_the_card_is_the_binned_selection():
    """``scan(approx=True)`` on the card returns the binned selection of
    the same rank values (computed on the CPU by the plain twin)."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    n, g, w, cb, q = 300_000, 4, 4, 128, 16
    codes = rng.integers(0, 1 << 32, (n, g, w), dtype=np.uint64) \
        .astype(np.uint32)
    qbits = torch.from_numpy(ths.unpack_bits_numpy(codes[:q], cb))
    tomb = torch.from_numpy(rng.random(n) < 0.01)
    tomb[:q] = False
    st = ths.build_scan_state(codes, cb, device=dev)
    res = ths.scan(st, qbits.to(dev), tomb.to(dev), 2_000, approx=True)
    dots = ths._bit_dots(qbits.to(dev), st.bits).cpu()
    wb, r = at.reduction_output_size(n, 2_000)
    sc, ids = at.binned_rank_topk(dots, 2_000, wb, r, popc=st.popc.cpu(),
                                  scale=-2, dead=tomb)
    qpopc = qbits.to(torch.int32).sum(dim=1, dtype=torch.int32)
    assert torch.equal(res.ids.cpu(), ids)
    assert torch.equal(res.scores.cpu(), sc + qpopc[:, None])
    assert (res.ids.cpu()[:, 0] == torch.arange(q)).all()   # self first


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["index", "index packed", "sharded"])
def test_served_scan_route_launches_approx_topk(entry):
    """The served scan route selects with the approximate top-L by default,
    as the JAX package's did on the TPU: a scan-mode index's
    ``route_batch`` (unpacked and packed state) launches the kernel once a
    batch, ``ShardedIndex.scan_route`` once a shard, and each returns what
    the same scan returns with ``approx=True``."""
    from fspann_tpu_torch.config import (EvalConfig, PaperConfig,
                                         RuntimeConfig, SystemConfig)
    from fspann_tpu_torch.index.service import PartitionedIndex
    from fspann_tpu_torch.ops import coding
    from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh

    dev = _cuda()
    rng = np.random.default_rng(6)
    n, d, limit = 40_000, 32, 100
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = base[:64] + rng.normal(size=(64, d)).astype(np.float32) * 0.1
    if entry == "sharded":
        bank = coding.build_bank_from_sample(base[:1000], 64, 2, 8, 3, 13)
        idx = ShardedIndex(make_mesh(4, device=dev), bank, block_size=128)
        idx.build(base, keep_base=False, keep_bits=True)
        assert at.reduction_output_size(idx.shard_rows, limit)[1] > 0
        before = at.partial_reduce.launches
        got = idx.scan_route(queries, limit=limit)
        assert at.partial_reduce.launches == before + 4
        want = idx.scan_route(queries, limit=limit, approx=True)
        exact = idx.scan_route(queries, limit=limit, approx=False)
    else:
        cfg = SystemConfig(
            paper=PaperConfig(m=64, lam=2, divisions=3, tables=8, seed=13),
            runtime=RuntimeConfig(
                refinement_limit=limit, max_global_candidates=limit,
                block_size=128, routing_mode="scan", encode_backend="cpu",
                scan_packed="on" if entry == "index packed" else "off",
                scan_native="off", adaptive_decrypt_margin=40),
            eval=EvalConfig(k_variants=(1, 10))).validate()
        idx = PartitionedIndex(cfg, d, device=dev)
        idx.stage(np.arange(n), base)
        idx.finalize()
        assert at.reduction_output_size(n, limit)[1] > 0
        qcodes, qkeys = idx.encode_queries(queries)
        before = at.partial_reduce.launches
        res = idx.route_batch(qcodes, qkeys)
        assert at.partial_reduce.launches == before + 1
        cb, rt = cfg.paper.code_bits, cfg.runtime
        qbits = torch.from_numpy(ths.unpack_bits_numpy(qcodes, cb)).to(dev)
        kw = dict(anchor=rt.adaptive_decrypt_anchor,
                  margin=rt.adaptive_decrypt_margin,
                  floor=rt.adaptive_decrypt_floor, code_bits=cb)
        st, tomb = idx._scan_state, idx._tombstones_scan()
        got = (res.ids.cpu().numpy(), res.scores.cpu().numpy())
        want, exact = ((r.ids.cpu().numpy(), r.scores.cpu().numpy())
                       for r in (ths.scan_chunked(st, qbits, tomb, limit,
                                                  approx=a, **kw)
                                 for a in (True, False)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # not the exact top-L everywhere, and never a better score than it
    assert (got[1] >= exact[1]).all()
    kept = np.mean([len(np.intersect1d(g, e)) / len(e)
                    for g, e in zip(got[0], exact[0])])
    assert 0.9 <= kept < 1.0, kept
