"""The probe slice's device code on a CUDA card against its plain torch
version on the CPU: the candidate-Hamming kernel (csrc/code_hamming.cu),
both of its paths, bit for bit, and the partition build, route, device
encode and refine.

Every test here needs a card and skips without one (the kernel has no CPU
mode).  The file imports no jax, so it runs on a GPU host without it:
``python -m pytest --noconftest -m cuda tests/test_torch_probe_cuda.py``."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import code_hamming as ch
from fspann_tpu_torch.ops import coding, partition, refine, routing

FIELDS = ("ids", "scores", "n_unique", "n_raw")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return "cuda"


def _words(rng, shape):
    return coding.words_to_torch(rng.integers(
        0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,q,r", [(5000, 96, 64, 4096),
                                     (3000, 192, 7, 1000), (700, 3, 1, 77),
                                     (900, 12, 3, 5000)])
def test_code_hamming_cuda_kernel_matches_plain(card, n, c, q, r):
    rng = np.random.default_rng(n)
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = torch.from_numpy(rng.integers(-3, n + 3, size=(q, r))
                           .astype(np.int32))
    ids[:, :3] = torch.tensor([-1, n, routing.INT32_MAX])
    want = ch.code_hamming_plain(pc, qc, ids)
    before = ch.code_hamming.launches
    got = ch.code_hamming(pc.to(card), qc.to(card), ids.to(card))
    torch.cuda.synchronize()
    assert ch.code_hamming.launches == before + 1
    assert torch.equal(got.cpu(), want)


PATHS = {"gather": ch.code_hamming_gather, "sweep": ch.code_hamming_sweep}


def _ascending_ids(rng, n, q, r):
    """Live ids ascending with the column, duplicates masked in place, pads
    of every kind in between."""
    ids = np.sort(rng.integers(0, n, size=(q, r)), axis=1).astype(np.int32)
    ids[:, 1:][ids[:, 1:] == ids[:, :-1]] = routing.INT32_MAX
    ids[rng.random((q, r)) < 0.1] = routing.INT32_MAX
    ids[:, 5::41] = -1
    ids[:, 6::41] = n
    return ids


# (n, c, q, r): every width class (1 word, W = 3, the 3,072- and 6,144-bit
# codes), R off the gather block's 64 columns and the pre-pass's 256, N off
# the window's rows, spans far longer than the 16 ids staged ahead (r >> n)
EDGES = [(5000, 96, 64, 4096), (3001, 192, 7, 1000), (700, 3, 1, 77),
         (900, 1, 3, 4099), (20_000, 96, 64, 777), (600, 12, 5, 4096),
         (129, 96, 2, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("n,c,q,r", EDGES)
def test_code_hamming_cuda_paths_match_plain(card, path, n, c, q, r):
    rng = np.random.default_rng(n + c)
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = _ascending_ids(rng, n, q, r)
    ids[(ids >= 256) & (ids < 512)] = routing.INT32_MAX   # windows nobody names
    if q > 2:
        ids[2] = -1                                       # no live id at all
    ids = torch.from_numpy(ids)
    want = ch.code_hamming_plain(pc, qc, ids)
    before = ch.code_hamming.launches
    got = PATHS[path](pc.to(card), qc.to(card), ids.to(card))
    torch.cuda.synchronize()
    assert ch.code_hamming.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3, 5, 9])
def test_code_hamming_cuda_sweep_any_window(card, shift):
    rng = np.random.default_rng(shift)
    n, c, q, r = 1500, 12, 6, 900
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = torch.from_numpy(_ascending_ids(rng, n, q, r))
    got = ch.code_hamming_sweep(pc.to(card), qc.to(card), ids.to(card), shift,
                                threads=128)
    assert torch.equal(got.cpu(), ch.code_hamming_plain(pc, qc, ids))


@pytest.mark.cuda
def test_code_hamming_cuda_false_promise_is_exact(card):
    """Shuffled ids under ``ascending=True``, at sizes where the wrapper
    picks the sweep: slow, and still equal to the plain twin."""
    rng = np.random.default_rng(9)
    n, c, q, r = 5000, 12, 8, 2000
    assert ch.choose_path(q, r, n, c, True) == "sweep"
    pc, qc = _words(rng, (n, c)), _words(rng, (q, c))
    ids = _ascending_ids(rng, n, q, r)
    ids = torch.from_numpy(np.stack([row[rng.permutation(r)] for row in ids]))
    got = ch.code_hamming(pc.to(card), qc.to(card), ids.to(card),
                          ascending=True)
    assert torch.equal(got.cpu(), ch.code_hamming_plain(pc, qc, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_code_hamming_cuda_unaligned_point_codes(card, path):
    """A contiguous view 4 bytes off a 16-byte boundary: the kernel copies
    it 4 bytes at a time."""
    rng = np.random.default_rng(4)
    n, c, q, r = 3000, 96, 9, 1500
    flat = _words(rng, (n * c + 1,)).to(card)
    pc = flat[1:].view(n, c)
    assert pc.is_contiguous() and pc.data_ptr() % 16 == 4
    qc = _words(rng, (q, c))
    ids = torch.from_numpy(_ascending_ids(rng, n, q, r))
    got = PATHS[path](pc, qc.to(card), ids.to(card))
    assert torch.equal(got.cpu(), ch.code_hamming_plain(pc.cpu(), qc, ids))


@pytest.mark.cuda
def test_code_hamming_cuda_sweep_back_to_back(card):
    """Two sweeps on one stream with no synchronisation between: each resets
    its own span table."""
    rng = np.random.default_rng(6)
    n, c, q, r = 4000, 96, 16, 1000
    pc, qc = _words(rng, (n, c)).to(card), _words(rng, (q, c)).to(card)
    a = torch.from_numpy(_ascending_ids(rng, n, q, r)).to(card)
    b = torch.from_numpy(_ascending_ids(rng, n // 2, q, r)).to(card)
    got = [ch.code_hamming_sweep(pc, qc, ids) for ids in (a, b, a)]
    torch.cuda.synchronize()
    for ids, g in zip((a, b, a), got):
        assert torch.equal(g, ch.code_hamming_plain(pc, qc, ids))


@pytest.mark.cuda
def test_code_hamming_cuda_rejects_non_contiguous(card):
    pc = torch.zeros((10, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ch.code_hamming(pc[:, ::2], torch.zeros((2, 4), dtype=torch.int32,
                                                device=card),
                        torch.zeros((2, 3), dtype=torch.int32, device=card))


def _corpus_state(wide):
    rng = np.random.default_rng(5)
    base = rng.normal(size=(4000, 16)).astype(np.float32)
    bank = coding.build_bank_from_sample(base, 64, 2, 2, 3, 3)
    codes, keys = coding.encode_numpy(base, bank)
    table = partition.build_partitions_numpy(
        np.ascontiguousarray(keys.T),
        np.ascontiguousarray(codes.transpose(1, 0, 2)), 32, wide=wide)
    return rng, base, bank, codes, keys, table


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_build_partitions_cuda_matches_numpy(card, wide):
    _, _, _, codes, keys, host = _corpus_state(wide)
    dev = partition.build_partitions(
        torch.from_numpy(np.ascontiguousarray(keys.T)).to(card),
        coding.words_to_torch(np.ascontiguousarray(
            codes.transpose(1, 0, 2)), card), 32, wide=wide)
    got = partition.table_to_numpy(dev)
    for f in host._fields:
        a, b = getattr(got, f), getattr(host, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_route_cuda_matches_cpu(card, wide):
    rng, base, bank, codes, _, host = _corpus_state(wide)
    cpu, dev = partition.table_to(host, "cpu"), partition.table_to(host, card)
    qc, qk = coding.encode_numpy(base[:17] + 0.1, bank)
    tomb = torch.from_numpy(rng.random(len(base)) < 0.02)
    a = (coding.words_to_torch(qc), torch.from_numpy(qk), tomb)
    pc = coding.words_to_torch(codes)
    for fn, extra in ((routing.route, (4, 500)),
                      (routing.route_rerank, (pc, 4, 200))):
        want = fn(cpu, *a, *extra)
        got = fn(dev, *(t.to(card) for t in a),
                 *(e.to(card) if torch.is_tensor(e) else e for e in extra))
        for f in FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    res = routing.route(cpu, *a, 4, 500)
    want = routing.rerank(pc, a[0], res, 100)
    got = routing.rerank(pc.to(card), a[0].to(card),
                         routing.RouteResult(*(t.to(card) for t in res[:4])),
                         100)
    for f in FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
def test_device_encode_cuda_flips_at_most_1e4_of_the_bits(card):
    _, base, bank, codes, keys, _ = _corpus_state(False)
    got, gkeys = coding.encode(torch.from_numpy(base).to(card),
                               coding.bank_to(bank, card))
    flips = np.unpackbits((coding.words_to_numpy(got) ^ codes)
                          .view(np.uint8)).sum()
    assert flips <= 1e-4 * codes.size * 32
    assert torch.equal(gkeys.cpu(), coding.keys_from_codes(got).cpu())


@pytest.mark.cuda
def test_refine_cuda_matches_cpu(card):
    rng = np.random.default_rng(2)
    q, r, d = 64, 2000, 128
    args = [torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(q, r, d)).astype(np.float32)),
            torch.from_numpy(rng.permutation(q * r).reshape(q, r)
                             .astype(np.int32)),
            torch.from_numpy(rng.random((q, r)) < 0.8)]
    want = refine.refine(*args, 10)
    got = refine.refine(*(t.to(card) for t in args), 10)
    np.testing.assert_allclose(got.distances.cpu().numpy(),
                               want.distances.numpy(), rtol=1e-6)
    assert torch.equal(got.n_scored.cpu(), want.n_scored)
