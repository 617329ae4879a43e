"""The probe route's device code at the shapes of the 10M-row probe
configuration (``bench_torch/configs/deep10m-probe.json``: 48 groups of 2
words, 16 probes of 128-row blocks, 64 queries a batch; and at 8 probes,
its source profile's count) on a CUDA card.

Past 2^21 rows a batch's 64 x 49,152 candidate slots at 8 probes (past
2^22, its 64 x 98,304 at 16) are fewer than 1.5 a row, so
``code_hamming`` scores them by the kernel's gather path; the
gather's scores equal the plain version's there, and the call counts its
slots as gathered (``code_hamming.slots``, ``code_hamming.gather_slots``),
where a sweep-shaped call counts none.  The device partition build over
[48, N] narrow keys equals the host build.

Every test here needs a card and skips without one (the kernel has no CPU
mode).  The file imports no jax:
``python -m pytest --noconftest -m cuda tests/test_torch_probe_10m_cuda.py``."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import code_hamming as ch
from fspann_tpu_torch.ops import coding, partition, routing
from fspann_tpu_torch.utils import profiler

# the configuration's geometry: 6 tables x 8 divisions, m 24, lambda 2
GROUPS, WORDS, BLOCK, Q = 48, 2, 128, 64
C = GROUPS * WORDS                  # 96 words a row


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return "cuda"


def _words(gen, shape, card):
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                         device=card, generator=gen).to(torch.int32)


def _routed_ids(gen, n, r, card):
    """A route_rerank batch's ids: ascending with the column, duplicates
    and pads INT32_MAX, every query's pads at its end."""
    ids = torch.sort(torch.randint(0, n, (Q, r), device=card,
                                   generator=gen), dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = torch.where(dup, torch.full_like(ids, routing.INT32_MAX), ids)
    return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()


def _counted(fn):
    """(result, slots, gather slots) of ``fn()``, by the process counters."""
    before = profiler.totals()["counters"]
    out = fn()
    after = profiler.totals()["counters"]
    return out, *(after.get(k, 0) - before.get(k, 0)
                  for k in ("code_hamming.slots",
                            "code_hamming.gather_slots"))


@pytest.mark.cuda
@pytest.mark.parametrize("probes,n", [(8, 2_200_000), (16, 4_400_000)])
def test_gather_at_the_10m_probe_shape_matches_plain_and_counts(card, probes,
                                                                n):
    r = GROUPS * probes * BLOCK
    assert Q * r < ch.SWEEP_MIN_SLOTS_PER_ROW * n
    assert ch.choose_path(Q, r, n, C, True) == "gather"
    gen = torch.Generator(device=card).manual_seed(n)
    pc, qc = _words(gen, (n, C), card), _words(gen, (Q, C), card)
    ids = _routed_ids(gen, n, r, card)
    before = ch.code_hamming.launches
    got, slots, gathered = _counted(
        lambda: ch.code_hamming(pc, qc, ids, ascending=True))
    want = ch.code_hamming_plain(pc, qc, ids)
    torch.cuda.synchronize()
    assert ch.code_hamming.launches == before + 1
    assert torch.equal(got, want)
    assert slots == gathered == Q * r


@pytest.mark.cuda
def test_sweep_shaped_call_counts_no_gathered_slots(card):
    n, r = 20_000, 4096
    assert ch.choose_path(Q, r, n, C, True) == "sweep"
    gen = torch.Generator(device=card).manual_seed(20_000)
    pc, qc = _words(gen, (n, C), card), _words(gen, (Q, C), card)
    ids = torch.sort(torch.randint(0, n, (Q, r), device=card,
                                   generator=gen), dim=1).values
    ids = ids.to(torch.int32).contiguous()
    got, slots, gathered = _counted(
        lambda: ch.code_hamming(pc, qc, ids, ascending=True))
    assert torch.equal(got, ch.code_hamming_plain(pc, qc, ids))
    assert (slots, gathered) == (Q * r, 0)


@pytest.mark.cuda
def test_build_partitions_48_narrow_groups_cuda_matches_numpy(card):
    """[48, N] 48-bit keys (narrow: no second key), N off the block, rows
    repeated so that keys tie and break by id."""
    rng = np.random.default_rng(48)
    n = 262_147
    base = rng.normal(size=(n, 96)).astype(np.float32)
    base[1::5] = base[0:-1:5][:len(base[1::5])]
    bank = coding.build_bank_from_sample(base[:100_000], 24, 2, 6, 8, 13)
    codes, keys = coding.encode_numpy(base, bank)
    assert codes.shape[1:] == (GROUPS, WORDS)
    keys_g = np.ascontiguousarray(keys.T)
    codes_g = np.ascontiguousarray(codes.transpose(1, 0, 2))
    host = partition.build_partitions_numpy(keys_g, codes_g, BLOCK)
    dev = partition.build_partitions(torch.from_numpy(keys_g).to(card),
                                     coding.words_to_torch(codes_g, card),
                                     BLOCK)
    got = partition.table_to_numpy(dev)
    assert got.min_key2 is None and host.min_key2 is None
    for f in host._fields:
        a, b = getattr(got, f), getattr(host, f)
        if b is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
