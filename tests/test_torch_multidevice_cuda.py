"""The sharded index over several slots on CUDA devices: 4 slots on one
card, and one slot on each card where the host has several, against the
one-slot mesh on the first card, bit for bit (ids and scores of the scan,
unpacked and packed, ``approx`` off and on, both merges, and of the probe
route with the full-code re-rank); the kernels against their plain
versions on a card other than the first; and the ``"host"`` merge's copies
from every card finished before ``get()`` returns.

At 100k rows of 3,072-bit codes (24 groups x 128 bits), 8 shards, device
encode.  The one-slot mesh and the slots encode on the same kind of card
with the same shapes, so the codes are equal; the test asserts it.

No top-level jax import: on a GPU host these run with
``python -m pytest --noconftest -m cuda tests/test_torch_multidevice_cuda.py``
and skip where there are not enough CUDA devices."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops.approx_topk import (partial_reduce,
                                              partial_reduce_plain,
                                              reduction_output_size)
from fspann_tpu_torch.ops.code_hamming import (code_hamming,
                                               code_hamming_gather,
                                               code_hamming_plain,
                                               code_hamming_sweep)
from fspann_tpu_torch.ops.l2_topk import (F32_ERROR_LIMIT, float64_error,
                                          l2_topk)
from fspann_tpu_torch.ops.refine import bruteforce_topk
from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh
from fspann_tpu_torch.query.service import _HostCopy

N, D, NQ, L, ND = 100_000, 32, 64, 2000, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N, D)).astype(np.float32) * 2
    queries = base[rng.integers(0, N, NQ)] + \
        rng.normal(size=(NQ, D)).astype(np.float32) * 0.3
    bank = coding.build_bank_from_sample(base[:1000], 64, 2, 8, 3, 13)
    dead = rng.choice(N, 1000, replace=False)
    return base, queries, bank, dead


def _same(got, want, what):
    for g, w, name in zip(got, want, ("ids", "scores")):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def _build(mesh, bank, base, dead, layout):
    idx = ShardedIndex(mesh, bank, block_size=128)
    idx.build(base, keep_base=False, keep_codes=True, keep_bits=layout,
              capacity=N + 4096)
    idx.mark_deleted(dead)
    return idx


def _assert_slots_equal_one_slot(slots):
    """Every route over ``slots`` == the one-slot mesh on the first card."""
    base, queries, bank, dead = _inputs()
    for layout in (True, "packed"):
        one = _build(make_mesh(ND, device=slots[0]), bank, base, dead, layout)
        many = _build(make_mesh(ND, devices=slots), bank, base, dead, layout)
        parts = many._per_device(many.words if layout == "packed"
                                 else many.bits)
        assert [p.device for p in parts] == list(many.mesh.slots)
        assert np.array_equal(many._gather_host(many.point_codes),
                              one._gather_host(one.point_codes)), "codes"
        for merge in ("ici", "host"):
            one.merge_backend = many.merge_backend = merge
            for approx in (False, True):
                for q in (NQ, 7):
                    _same(many.scan_route(queries[:q], limit=L,
                                          approx=approx),
                          one.scan_route(queries[:q], limit=L, approx=approx),
                          (layout, merge, approx, q))
        if layout is True:
            before = code_hamming.launches
            got = many.route(queries, probes=4, refinement_limit=4096,
                             rerank_limit=500)
            assert code_hamming.launches == before + ND
            _same(got, one.route(queries, probes=4, refinement_limit=4096,
                                 rerank_limit=500), "re-rank route")


@pytest.mark.cuda
def test_four_slots_on_one_card_match_one_slot(cuda):
    _assert_slots_equal_one_slot([cuda] * 4)


@pytest.mark.cuda
def test_one_slot_per_card_matches_one_card(cards):
    _assert_slots_equal_one_slot(cards[:4] if len(cards) >= 4
                                 else cards[:2])


@pytest.mark.cuda
def test_kernels_match_plain_on_second_card(cards):
    dev = cards[1]
    rng = np.random.default_rng(9)
    pc = torch.from_numpy(rng.integers(-2**31, 2**31, (50_000, 96),
                                       dtype=np.int64).astype(np.int32))
    qc = pc[rng.integers(0, 50_000, 16)].clone()
    ids = torch.from_numpy(rng.integers(-1, 50_000, (16, 3000))
                           .astype(np.int32))
    want = code_hamming_plain(pc, qc, ids)
    for path in (code_hamming_gather, code_hamming_sweep):
        got = path(pc.to(dev), qc.to(dev), ids.to(dev))
        assert got.device == dev and torch.equal(got.cpu(), want), path
    part = torch.from_numpy(rng.integers(-3000, 3000, (16, 250_000))
                            .astype(np.int32))
    popc = torch.from_numpy(rng.integers(0, 3072, 250_000).astype(np.int32))
    dead = torch.from_numpy(rng.random(250_000) < 0.01)
    w, r = reduction_output_size(250_000, L)
    got = partial_reduce(part.to(dev), w, r, 17, popc.to(dev), -2,
                         dead.to(dev))
    assert got.device == dev
    assert torch.equal(got.cpu(), partial_reduce_plain(part, w, r, 17, popc,
                                                       -2, dead))
    # as tests/test_torch_l2_topk.py holds it: random queries against the
    # plain twin, and float32-accurate against float64 (the kernel ranks by
    # |b|^2 - 2 q.b, so a distance next to 0 is not held to a relative
    # tolerance: self searches go by the float64 bound alone)
    base = torch.from_numpy(rng.normal(size=(20_000, 128)).astype(np.float32))
    for q, plain in ((torch.from_numpy(rng.normal(size=(32, 128))
                                       .astype(np.float32)), True),
                     (base[:32] + 0.01, False)):
        ids_k, d_k = l2_topk(base.to(dev), q.to(dev), 100)
        assert ids_k.device == dev
        assert float64_error(base, q, ids_k.cpu(), d_k.cpu()) \
            <= F32_ERROR_LIMIT
        if plain:
            torch.testing.assert_close(d_k.cpu(), bruteforce_topk(base, q,
                                                                  100)[1],
                                       rtol=2e-4, atol=1e-4)


@pytest.mark.cuda
def test_host_copy_waits_for_every_card(cards):
    """The copy from the second card is queued behind a second of work on
    that card's stream; ``get()`` must still return what it copies (one
    event per source device, not one on the current device)."""
    first, second = cards[0], cards[1]
    a = torch.full((1 << 20,), 3, dtype=torch.int32, device=first)
    b = torch.zeros((1 << 20,), dtype=torch.int32, device=second)
    with torch.cuda.device(second):
        torch.cuda._sleep(int(2e9))
        b.fill_(7)
    with torch.cuda.device(first):
        got = _HostCopy([a, b]).get()
    assert (got[0] == 3).all() and (got[1] == 7).all()
