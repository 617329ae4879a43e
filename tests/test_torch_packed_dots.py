"""Bit products straight from packed words (fspann_tpu_torch/ops/packed_dots.py)
on the CPU: the plain version against the unpack plus int8 product and a
numpy statement; a numpy model of the kernel's arithmetic (its query words,
its register masks and mma.sync's fragment layout) against the plain
version; and the chunked scan's use of the wrapper and its counters.  The
kernel itself is held to the plain version on the card in
tests/test_torch_packed_dots_cuda.py."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import hamming_scan as ths
from fspann_tpu_torch.ops import packed_dots as pd
from fspann_tpu_torch.utils import profiler

torch.set_num_threads(1)

# (G, W, code_bits): the deep and SIFT codes' 24 x 4 words; widths below
# 32 W; a word count that is not a multiple of 4 (the kernel's word-by-word
# loads) and one under a whole 16-word slice
WIDTHS = [(24, 4, 128), (3, 4, 120), (3, 3, 72), (2, 4, 100), (5, 2, 64)]


def _words(rng, n, g, w, cb):
    """uint32 words [n, G, W] with zero pad bits past ``cb`` in each
    group, as ops/coding packs them."""
    bits = rng.integers(0, 2, size=(n, g, 32 * w), dtype=np.uint8)
    bits[:, :, cb:] = 0
    return np.packbits(bits, axis=-1).view(">u4").astype(np.uint32).reshape(
        n, g, w)


def _qbits(rng, q, g, cb):
    return torch.from_numpy(rng.integers(0, 2, size=(q, g * cb),
                                         dtype=np.int8))


def _numpy_dots(qbits, codes, cb):
    bits = ths.unpack_bits_numpy(codes, cb).astype(np.int64)
    return qbits.numpy().astype(np.int64) @ bits.T


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("q", [1, 7, 64, 65])
@pytest.mark.parametrize("g,w,cb", WIDTHS)
def test_plain_equals_unpack_and_int_mm(rng, g, w, cb, q, dtype):
    """Integer for integer: the unpack plus ``_bit_dots`` and a numpy
    product, for int32 and int64-held words, at a ragged row count."""
    codes = _words(rng, 301, g, w, cb)
    qbits = _qbits(rng, q, g, cb)
    words = torch.from_numpy(codes.view(np.int32))
    if dtype == torch.int64:
        words = torch.from_numpy(codes.astype(np.int64))
    got = pd.packed_dots(qbits, words, cb)
    assert got.dtype == torch.int32 and got.shape == (q, 301)
    want = ths._bit_dots(qbits, ths.unpack_bits_device(words, cb))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _numpy_dots(qbits, codes, cb))


def _query_words(qbits, g, w, cb):
    """csrc/packed_dots.cu query_words_kernel: byte i of word holds, in bit
    e, the query bit at MSB-first place 8 (3 - i) + e; zero past cb."""
    q = qbits.shape[0]
    bits = np.zeros((q, g, 32 * w), np.uint64)
    bits[:, :, :cb] = qbits.numpy().reshape(q, g, cb)
    p = np.arange(32)
    shift = (8 * (3 - p // 8) + p % 8).astype(np.uint64)
    return (bits.reshape(q, g * w, 32) << shift).sum(-1).astype(np.uint32)


def _mma(a_regs, b_regs):
    """mma.sync m16n8k32 u8 x u8 -> s32 over one warp's registers (PTX
    fragment layout): a_regs [32 lanes, 4], b_regs [32, 2] -> D [16, 8]."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r in range(4):
            row, k0 = g + 8 * (r & 1), 4 * t + 16 * (r >> 1)
            for i in range(4):
                a[row, k0 + i] = (int(a_regs[lane][r]) >> (8 * i)) & 0xFF
        for r in range(2):
            for i in range(4):
                b[4 * t + 16 * r + i, g] = (int(b_regs[lane][r])
                                            >> (8 * i)) & 0xFF
    return a @ b


def _kernel_model(qwords, words, gw):
    """The product kernel's arithmetic for one m16 tile of rows and one n8
    tile of queries (rows [16, gw] and query words [8, gw], uint32): its
    slices, register masks and accumulation, then the shift by 7."""
    low = 0x01010101
    acc = np.zeros((16, 8), np.int64)

    def word(arr, r, i):
        return int(arr[r, i]) if i < gw else 0

    for s in range(-(-gw // 16)):
        for ws in range(4):
            for jp in range(4):
                m0, m1 = low << 2 * jp, low << 2 * jp + 1
                n0, n1 = low << 7 - 2 * jp, low << 6 - 2 * jp
                a_regs, b_regs = [], []
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    wi = 16 * s + 4 * t + ws
                    lo, hi = word(words, g, wi), word(words, g + 8, wi)
                    a_regs.append((lo & m0, hi & m0, lo & m1, hi & m1))
                    qw = word(qwords, g, wi)
                    b_regs.append((qw & n0, qw & n1))
                acc += _mma(a_regs, b_regs)
    assert (acc % 128 == 0).all()
    return (acc >> 7).T                                    # [8 q, 16 rows]


@pytest.mark.parametrize("g,w,cb", WIDTHS)
def test_kernel_arithmetic_model_matches_plain(rng, g, w, cb):
    """The kernel's design on the CPU: its query words, masks and the
    fragment layout give the plain version's products exactly."""
    codes = _words(rng, 16, g, w, cb)
    qbits = _qbits(rng, 8, g, cb)
    model = _kernel_model(_query_words(qbits, g, w, cb),
                          codes.reshape(16, g * w), g * w)
    want = pd.packed_dots(qbits, torch.from_numpy(codes.view(np.int32)), cb)
    np.testing.assert_array_equal(model, want.numpy())


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    codes = torch.from_numpy(_words(rng, 10, 3, 4, 120).view(np.int32))
    qbits = _qbits(rng, 2, 3, 120)
    with pytest.raises(ValueError):
        pd.packed_dots(qbits, codes, 128)                  # width mismatch
    with pytest.raises(ValueError):
        pd.packed_dots(_qbits(rng, 2, 3, 129), codes, 129)  # > 32 W
    with pytest.raises(TypeError):
        pd.packed_dots(qbits.to(torch.int32), codes, 120)
    with pytest.raises(TypeError):
        pd.packed_dots(qbits, codes.to(torch.int16), 120)
    with pytest.raises(TypeError):
        pd.packed_dots(qbits, codes.reshape(10, 12), 120)


def _counted(fn):
    """``fn()`` under a root span; returns (its value, the root's
    ``scan.rows`` and ``scan.packed_rows``)."""
    with profiler.span("test.packed_dots"):
        out = fn()
    (root,) = profiler.recent("test.packed_dots", 1)
    return out, root.get("scan.rows", 0), root.get("scan.packed_rows", 0)


@pytest.mark.parametrize("n,chunk", [(3 * 128 + 60, 128),
                                     (3 * 128 + 5, 128), (300, 512)])
def test_packed_scans_call_the_wrapper_and_count_rows(rng, monkeypatch, n,
                                                      chunk):
    """A packed state's chunked scan (whole chunks, a tail scanned as it
    is, a tail re-read from n - chunk, and a state under one chunk) scores
    every block through ``packed_dots`` on its words and counts the rows it
    scored, packed and in all; the result equals the unpacked scan's."""
    g, w, cb, limit = 24, 4, 128, 60
    codes = _words(rng, n, g, w, cb)
    qbits = _qbits(rng, 5, g, cb)
    tomb = torch.from_numpy(rng.random(n) < 0.05)
    calls = []
    real = ths.packed_dots

    def spy(qb, words, code_bits):
        calls.append((tuple(words.shape), code_bits))
        return real(qb, words, code_bits)

    monkeypatch.setattr(ths, "packed_dots", spy)
    packed = ths.build_scan_state_packed(codes, cb)
    got, rows, prows = _counted(lambda: ths.scan_chunked(
        packed, qbits, tomb, limit, chunk=chunk, code_bits=cb, anchor=10,
        margin=8))
    sizes = [s[0] for s, _ in calls]
    assert all(s[1:] == (g, w) and c == cb for s, c in calls)
    assert rows == prows == sum(sizes) >= n
    if n <= chunk:
        assert sizes == [n]
    else:
        assert len(sizes) == -(-n // chunk)
    flat, frows, fprows = _counted(lambda: ths.scan_chunked(
        ths.build_scan_state(codes, cb), qbits, tomb, limit, chunk=chunk,
        anchor=10, margin=8))
    assert (frows, fprows) == (rows, 0)
    assert len(calls) == len(sizes)          # the bits never reach it
    for f in ("ids", "scores", "n_unique", "n_raw", "n_dec"):
        assert torch.equal(getattr(got, f), getattr(flat, f)), f

    calls.clear()
    _carry, rows, prows = _counted(lambda: ths.scan_chunks(
        packed.words, packed.popc, tomb, qbits, limit, chunk))
    assert rows == prows == sum(s[0] for s, _ in calls)


def test_unpacked_scan_counts_rows_only(rng):
    codes = _words(rng, 200, 3, 4, 120)
    qbits = _qbits(rng, 3, 3, 120)
    st = ths.build_scan_state(codes, 120)
    _res, rows, prows = _counted(lambda: ths.scan(
        st, qbits, torch.zeros(200, dtype=torch.bool), 20))
    assert (rows, prows) == (200, 0)
