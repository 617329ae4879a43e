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
# a full chunk and the 1M chunked scan's tail (r 2), a 4-shard slice (r 1)
SHAPES = [(3, 1_000, 10), (7, 20_000, 100), (1, 129, 1), (2, 257, 1),
          (64, 1_000_000, 2_000), (64, 524_288, 2_000),
          (7, 475_712, 2_000), (1, 266_384, 2_000)]


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
