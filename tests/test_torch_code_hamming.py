"""The candidate-Hamming kernel's Python side (fspann_tpu_torch/ops/
code_hamming.py): which path the wrapper picks, the sweep's window geometry,
and the sweep's span rule.

The CUDA kernel cannot run here.  What the sweep path computes is emulated
in numpy and torch from the kernel's own rule (csrc/code_hamming.cu): a
pre-pass records, for each (window, query), the span of columns [first,
last) that holds every id of that window and writes INT32_MAX at every pad;
the sweep then visits each window, and scores from that window's rows alone
the columns of each span whose id lies in the window.  The emulation is
held bit for bit to ``code_hamming_plain`` and, through
``fspann_tpu.ops.hamming``, to the JAX package, on ids made with numpy from
a seed.  The kernel itself is held to the plain twin on the card by
tests/test_torch_probe_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.ops import hamming as jhamming
from fspann_tpu_torch.ops import code_hamming as ch
from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops.hamming import hamming

torch.set_num_threads(1)

INT32_MAX = 2 ** 31 - 1
EMPTY = 0x7F7F7F7F          # the span table after memset(0x7f)
M = 1_000_000


# (q, r, n, c, ascending) -> path.  The probe point, its 960-d twin, Q = 1,
# the measured crossover between Q = 16 and 32, sparse batches, an
# unordered batch, and batches whose queries leave no room for 64-row
# windows.
PATHS = [
    ((64, 49_152, M, 96, True), "sweep"),
    ((64, 49_152, M, 96, False), "gather"),
    ((64, 49_152, M, 192, True), "sweep"),
    ((16, 49_152, M, 192, True), "gather"),
    ((1, 49_152, M, 96, True), "gather"),
    ((8, 49_152, M, 96, True), "gather"),
    ((16, 49_152, M, 96, True), "gather"),
    ((32, 49_152, M, 96, True), "sweep"),
    ((64, 2000, M, 96, True), "gather"),
    ((64, 49_152, 10 * M, 96, True), "gather"),
    ((64, 49_152, 100_000, 96, True), "sweep"),
    ((256, 49_152, M, 96, True), "gather"),
    ((64, 49_152, M, 12, True), "sweep"),
    ((2000, 49_152, M, 1, True), "gather"),
]


@pytest.mark.parametrize("args,path", PATHS)
def test_choose_path(args, path):
    assert ch.choose_path(*args) == path


@pytest.mark.parametrize("c,q,shift", [(96, 64, 7), (192, 64, 6), (96, 1, 7),
                                       (96, 128, 6), (3, 64, 10), (1, 1, 10),
                                       (192, 256, -1)])
def test_window_shift_is_the_largest_that_fits(c, q, shift):
    assert ch.window_shift(c, q) == shift
    if shift >= 0:
        assert ch.sweep_smem_bytes(c, shift, q) <= ch.SWEEP_SMEM_BYTES
    if shift < ch.MAX_WINDOW_SHIFT:
        assert ch.sweep_smem_bytes(c, shift + 1, q) > ch.SWEEP_SMEM_BYTES


def test_sweep_smem_matches_the_kernels_layout():
    """csrc/code_hamming.cu's sweep_words at the probe point: the queries'
    codes, 3 windows of rows, 5 of spans, 3 of ids (16 a query, and 4 more
    for their alignment) and 2 item lists (a word an item)."""
    c, shift, q = 96, 7, 64
    words = c * q + 3 * (c << shift) + 5 * 2 * q + 3 * 20 * q + 2 * 16 * q
    assert ch.sweep_smem_bytes(c, shift, q) == 4 * words


def spans(ids, n, shift):
    """The pre-pass: int32 [windows, Q, 2] of (first, -last) over the
    columns whose id lies in the window, EMPTY where there is none; and the
    touched mark of each window."""
    q, r = ids.shape
    windows = -(-n // (1 << shift))
    table = np.full((windows, q, 2), EMPTY, np.int32)
    for qi in range(q):
        for col in range(r):
            i = ids[qi, col]
            if 0 <= i < n:
                w = i >> shift
                table[w, qi, 0] = min(table[w, qi, 0], col)
                table[w, qi, 1] = min(table[w, qi, 1], -(col + 1))
    touched = (table[:, :, 0] != EMPTY).any(axis=1)
    return table, touched


def sweep_emulated(pc, qc, ids, shift):
    """The sweep path's result from its own rule: only rows of the window
    in hand are read, only columns of a span are looked at."""
    n, c = pc.shape
    q, r = ids.shape
    out = np.full((q, r), -7, np.int32)          # -7: never written
    out[(ids < 0) | (ids >= n)] = INT32_MAX      # the pre-pass's pads
    table, touched = spans(ids, n, shift)
    for w in np.flatnonzero(touched):
        row0 = int(w) << shift
        window = coding.words_to_torch(pc[row0:row0 + (1 << shift)])
        rows = window.shape[0]                   # the last window is short
        for qi in range(q):
            first, nlast = table[w, qi]
            if first == EMPTY:
                continue
            for col in range(first, -nlast):
                local = int(ids[qi, col]) - row0
                if 0 <= local < rows:            # pads, strangers: skipped
                    assert out[qi, col] == -7    # scored exactly once
                    out[qi, col] = int(hamming(
                        window[local], coding.words_to_torch(qc[qi])))
    assert not (out == -7).any()
    return out, table, touched


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def _ascending_ids(rng, n, q, r):
    """Live ids ascending with the column, duplicates masked in place, pads
    of every kind in between: what ``route_rerank`` hands over."""
    ids = np.sort(rng.integers(0, n, size=(q, r)), axis=1).astype(np.int32)
    ids[:, 1:][ids[:, 1:] == ids[:, :-1]] = INT32_MAX
    ids[rng.random((q, r)) < 0.1] = INT32_MAX
    ids[:, 5::41] = -1
    ids[:, 6::41] = n
    return ids


def _check(pc, qc, ids, shift):
    n = pc.shape[0]
    got, table, touched = sweep_emulated(pc, qc, ids, shift)
    want = ch.code_hamming_plain(coding.words_to_torch(pc),
                                 coding.words_to_torch(qc),
                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(got, want.numpy())
    ok = (ids >= 0) & (ids < n)
    fine = np.asarray(jhamming.hamming(
        jnp.asarray(qc)[:, None, :], jnp.asarray(pc)[np.where(ok, ids, 0)]))
    np.testing.assert_array_equal(got, np.where(ok, fine, INT32_MAX))
    return table, touched


# (n, c, q, r, shift): N a multiple of T and not, one word, W = 3, the
# probe width, a window wider than the array
SWEEPS = [(640, 12, 5, 300, 5), (1000, 12, 5, 300, 5), (333, 1, 3, 200, 4),
          (500, 3, 4, 257, 6), (700, 96, 4, 150, 7), (50, 4, 2, 64, 8)]


@pytest.mark.parametrize("n,c,q,r,shift", SWEEPS)
def test_sweep_rule_on_ascending_ids(rng, n, c, q, r, shift):
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = _ascending_ids(rng, n, q, r)
    table, _ = _check(pc, qc, ids, shift)
    # ascending ids: the spans of one query do not overlap
    for qi in range(q):
        live = table[:, qi, 0] != EMPTY
        first, last = table[live, qi, 0], -table[live, qi, 1]
        assert (first[1:] >= last[:-1]).all()


def test_sweep_rule_empty_window_and_query_with_no_live_id(rng):
    n, c, q, r, shift = 640, 12, 4, 200, 5
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = _ascending_ids(rng, n, q, r)
    ids[(ids >= 64) & (ids < 128)] = INT32_MAX   # windows 2 and 3: nobody
    ids[2] = np.where(np.arange(r) % 2 == 0, -1, INT32_MAX)
    table, touched = _check(pc, qc, ids, shift)
    assert not touched[2] and not touched[3] and touched[4]
    assert (table[:, 2] == EMPTY).all()


@pytest.mark.parametrize("n,c,q,r,shift", SWEEPS[:3])
def test_sweep_rule_is_exact_for_shuffled_ids(rng, n, c, q, r, shift):
    """A false ``ascending=True``: the spans grow to most of the row and
    overlap, and every column is still scored once, by its id's window."""
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = _ascending_ids(rng, n, q, r)
    ids = np.stack([row[rng.permutation(r)] for row in ids])
    table, _ = _check(pc, qc, ids, shift)
    live = table[:, :, 0] != EMPTY
    assert (-table[:, :, 1] - table[:, :, 0])[live].mean() > r / 4


@pytest.mark.parametrize("ascending", [False, True])
def test_code_hamming_on_cpu_ignores_the_promise(rng, ascending):
    """On the CPU the wrapper runs the plain twin whatever is promised,
    true or false."""
    n, c, q, r = 400, 12, 3, 120
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = _ascending_ids(rng, n, q, r)
    ids = np.stack([row[rng.permutation(r)] for row in ids])
    args = (coding.words_to_torch(pc), coding.words_to_torch(qc),
            torch.from_numpy(ids))
    before = ch.code_hamming.launches
    got = ch.code_hamming(*args, ascending=ascending)
    assert ch.code_hamming.launches == before
    assert torch.equal(got, ch.code_hamming_plain(*args))


@pytest.mark.parametrize("fn", [ch.code_hamming_gather, ch.code_hamming_sweep])
def test_kernel_paths_refuse_cpu_tensors(fn):
    pc = torch.zeros((10, 4), dtype=torch.int32)
    qc = torch.zeros((2, 4), dtype=torch.int32)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        fn(pc, qc, ids)
