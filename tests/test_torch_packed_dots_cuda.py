"""The packed bit-product kernel (fspann_tpu_torch/csrc/packed_dots.cu) on the
card: against its plain version bit for bit, inside the chunked scan against
the unpacked state, and its device-memory footprint.  Every test needs a
CUDA device and skips without one; no jax here, so on a GPU host:

    python -m pytest --noconftest -m cuda tests/test_torch_packed_dots_cuda.py
"""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import hamming_scan as ths
from fspann_tpu_torch.ops import packed_dots as pd
from fspann_tpu_torch.ops.approx_topk import reduction_output_size

CHUNK = 1 << 19
DEEP_TAIL = 10_000_000 - 19 * CHUNK          # 38,528 rows


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(q, c, g, w, cb, seed, dev):
    """Query bits and words with every bit random, pad bits too (neither
    version reads a word's bits past ``cb``)."""
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(0, 2 ** 32, size=(c, g, w),
                                          dtype=np.uint32).view(np.int32))
    qbits = torch.from_numpy(rng.integers(0, 2, size=(q, g * cb),
                                          dtype=np.int8))
    return qbits.to(dev), words.to(dev)


# (Q, C, G, W, code_bits): the deep chunk, the deep scan's 38,528-row tail,
# Q around the 64-query tile, a width below 32 W (12 words: whole 16-byte
# loads, a ragged slice) and 9 words (word-by-word loads), a row count off
# the 256-row block
SHAPES = [(64, CHUNK, 24, 4, 128), (64, DEEP_TAIL, 24, 4, 128),
          (1, 100_003, 24, 4, 128), (7, 100_003, 24, 4, 128),
          (65, 100_003, 24, 4, 128), (64, 70_001, 3, 4, 120),
          (33, 70_001, 3, 3, 72), (130, 4_099, 2, 4, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,g,w,cb", SHAPES)
def test_kernel_matches_plain(q, c, g, w, cb):
    dev = _cuda()
    qbits, words = _inputs(q, c, g, w, cb, c + q, dev)
    before = pd.packed_dots.launches
    got = pd.packed_dots(qbits, words, cb)
    torch.cuda.synchronize()
    assert pd.packed_dots.launches == before + 1
    want = pd.packed_dots_plain(qbits, words, cb)
    assert torch.equal(got, want), (q, c, g, w, cb)


@pytest.mark.cuda
def test_kernel_reads_a_slice_off_the_block_grid_and_int64_words():
    """The ``left < k`` re-read: a chunk that starts at ``n - chunk`` of a
    larger state (a row offset no block boundary meets); and int64-held
    words, which the wrapper narrows first."""
    dev = _cuda()
    n = 3 * CHUNK + 1_999
    qbits, words = _inputs(64, n, 24, 4, 128, 11, dev)
    sl = words[n - CHUNK:]
    got = pd.packed_dots(qbits, sl, 128)
    assert torch.equal(got, pd.packed_dots_plain(qbits, sl, 128))
    small = words[:5_000].to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(pd.packed_dots(qbits, small, 128),
                       pd.packed_dots_plain(qbits, small, 128))


def _codes(n, seed):
    """uint32 codes [n, 24, 4] (3,072 bits, no pad bits)."""
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 24, 4),
                                                dtype=np.uint32)


FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2 * CHUNK + 300_000, 3 * CHUNK + 1_500,
                               400_000])
def test_packed_scan_on_the_card_equals_unpacked(n):
    """A packed ``scan_chunked`` on the card, which takes the kernel:
    exact, equal to the unpacked flat ``scan``; approximate, equal to the
    unpacked ``scan_chunked`` (the same blocks bin alike; a state under one
    chunk is one flat block either way)."""
    dev = _cuda()
    codes, cb = _codes(n, n), 128
    qcodes = _codes(64, n + 1)
    qbits = torch.from_numpy(ths.unpack_bits_numpy(qcodes, cb)).to(dev)
    tomb = torch.from_numpy(np.random.default_rng(n).random(n) < 0.02
                            ).to(dev)
    flat = ths.build_scan_state(codes, cb, device=dev)
    packed = ths.build_scan_state_packed(codes, cb, device=dev)
    kw = dict(anchor=100, margin=40)
    before = pd.packed_dots.launches
    got = ths.scan_chunked(packed, qbits, tomb, 2000, approx=False,
                           code_bits=cb, **kw)
    assert pd.packed_dots.launches == before + -(-n // CHUNK)
    want = ths.scan(flat, qbits, tomb, 2000, approx=False, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), ("exact", f)
    got = ths.scan_chunked(packed, qbits, tomb, 2000, code_bits=cb, **kw)
    want = ths.scan_chunked(flat, qbits, tomb, 2000, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), ("approx", f)


@pytest.mark.cuda
def test_packed_step_allocates_no_bit_block():
    """One 524,288-row packed step (``scan_chunk_merge`` on the words) grows
    the allocator's peak by the products and the selection's scratch, not
    by a chunk-sized int8 bit block (1.5 GiB at 3,072 bits)."""
    dev = _cuda()
    q, k, cb = 64, 2000, 128
    qbits, words = _inputs(q, CHUNK, 24, 4, cb, 5, dev)
    popc = torch.randint(1_200, 1_900, (CHUNK,), dtype=torch.int32,
                         device=dev)
    dead = torch.zeros(CHUNK, dtype=torch.bool, device=dev)
    carry = (torch.full((q, k), 1 << 30, dtype=torch.int32, device=dev),
             torch.full((q, k), -1, dtype=torch.int32, device=dev))

    def step():
        return ths.scan_chunk_merge(qbits, words, popc, dead, 0, 0, carry,
                                    approx=True, width=CHUNK)

    step()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - held
    products = q * CHUNK * 4
    w, _r = reduction_output_size(CHUNK, k)
    bins = q * w * 8
    print(f"packed step: peak grew {grown / 2**20:.1f} MiB (products "
          f"{products / 2**20:.1f} MiB, bins {bins / 2**20:.1f} MiB)")
    assert grown <= products + 3 * bins + (64 << 20), grown
    assert grown < CHUNK * 24 * cb // 2, grown
