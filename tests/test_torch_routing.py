"""Port's multi-probe route (fspann_tpu_torch/ops/routing.py) and the
candidate-Hamming kernel's plain twin (ops/code_hamming.py) against the JAX
package, bit for bit.

Both packages get the same seeded inputs: codes from the JAX host encoder,
the JAX-built table carried across with ``api.convert.table_from_jax``,
the same tombstones.  Every ``RouteResult`` field must be equal, for narrow
and wide keys; ``tests/oracles.py`` is a third check of ``route``.  On the
CPU ``code_hamming`` runs its plain twin; the CUDA kernel is held to that
twin by tests/test_torch_probe_cuda.py (and by ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu.ops import coding as jcoding
from fspann_tpu.ops import hamming as jhamming
from fspann_tpu.ops import partition as jpartition
from fspann_tpu.ops import routing as jrouting
from fspann_tpu_torch.api.convert import table_from_jax
from fspann_tpu_torch.ops import code_hamming as ch
from fspann_tpu_torch.ops import coding, partition, routing
from oracles import oracle_partitions, oracle_route

torch.set_num_threads(1)

FIELDS = ("ids", "scores", "n_unique", "n_raw")
I64MAX = np.iinfo(np.int64).max


def _setup(rng, n, m, lam, block, wide, tables=2, divisions=2, d=16):
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    jb = jcoding.build_bank_from_sample(base[:min(n, 1000)], m, lam, tables,
                                        divisions, 11)
    codes, keys = jcoding.encode_numpy(base, jb)
    jt = jpartition.build_partitions(
        jnp.asarray(np.ascontiguousarray(keys.T)),
        jnp.asarray(np.ascontiguousarray(codes.transpose(1, 0, 2))), block,
        wide=wide)
    return base, jb, codes, keys, jt, table_from_jax(jt)


def _queries(rng, base, jb, nq):
    q = base[rng.integers(0, len(base), nq)] \
        + rng.normal(size=(nq, base.shape[1])).astype(np.float32)
    return jcoding.encode_numpy(q, jb)


def _assert_route_equal(port, ref, fields=FIELDS):
    for f in fields:
        a, b = getattr(port, f), np.asarray(getattr(ref, f))
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


def test_find_center_edges():
    """Key below all / above all / inside / in a gap (the JAX test's
    table)."""
    t = partition.PartitionTable(
        torch.tensor([[10, 30, 60]]), torch.tensor([[19, 40, 70]]),
        torch.zeros((1, 3, 1), dtype=torch.int32),
        torch.zeros((1, 3, 4), dtype=torch.int32),
        torch.full((1, 3), 4, dtype=torch.int32))
    qkeys = torch.tensor([[0], [100], [35], [22], [55], [10], [70]])
    got = routing.find_center(t, qkeys)[:, 0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [0, 2, 1, 0, 2, 0, 2])


@pytest.mark.parametrize("wide", [False, True])
def test_find_center_matches_jax(rng, wide):
    base, jb, codes, keys, jt, tt = _setup(rng, 1500, 64, 2, 16, wide)
    qc, qk = _queries(rng, base, jb, 40)
    # keys below and above every partition, and exact boundaries
    qk[0] = 0
    qk[1] = I64MAX
    qk[2] = np.asarray(jt.min_key)[:, 3]
    qk[3] = np.asarray(jt.max_key)[:, 5]
    qc2 = np.array(jcoding.keys2_from_codes(jnp.asarray(qc))) \
        if wide else None
    ref = jrouting.find_center(jt, jnp.asarray(qk),
                               None if qc2 is None else jnp.asarray(qc2))
    got = routing.find_center(tt, torch.from_numpy(qk),
                              None if qc2 is None else torch.from_numpy(qc2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_find_center_wide_borrow_boundaries():
    """Pair distances whose second segment borrows, at the int64 edges:
    the ``^ -2**63`` sign flip must order them like the 126-bit value."""
    big = I64MAX
    min_key = np.array([[5, 7, 9, 9]], np.int64)
    max_key = np.array([[5, 7, 9, 11]], np.int64)
    min_key2 = np.array([[0, big - 1, 3, big]], np.int64)
    max_key2 = np.array([[10, big, 5, 0]], np.int64)
    jt = jpartition.PartitionTable(
        jnp.asarray(min_key), jnp.asarray(max_key),
        jnp.zeros((1, 4, 1), jnp.uint32), jnp.zeros((1, 4, 2), jnp.int32),
        jnp.full((1, 4), 2, jnp.int32), jnp.asarray(min_key2),
        jnp.asarray(max_key2))
    qk = np.array([[5], [6], [6], [6], [7], [8], [8], [9], [9], [10], [12],
                   [0], [big]], np.int64)
    qk2 = np.array([[11], [0], [big], [big // 2], [0], [0], [big], [4], [6],
                    [0], [0], [0], [big]], np.int64)
    ref = jrouting.find_center(jt, jnp.asarray(qk), jnp.asarray(qk2))
    got = routing.find_center(table_from_jax(jt), torch.from_numpy(qk),
                              torch.from_numpy(qk2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("max_probes", [1, 2, 5, 8])
def test_greedy_interval_matches_jax(rng, max_probes):
    v = 2 * max_probes - 1
    ham = rng.integers(0, 6, size=(7, 3, v)).astype(np.int32)  # many ties
    ham[rng.random(ham.shape) < 0.2] = routing.INT32_MAX
    lo, hi = jrouting._greedy_interval(jnp.asarray(ham), max_probes)
    tlo, thi = routing._greedy_interval(torch.from_numpy(ham), max_probes)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))


# (m, lam, block, wide, probes): W = 1, 3 (λ = 3), 4 and 2 words per group,
# the last the 10M probe configuration's groups (48-bit narrow keys, 8
# probes of 128-row blocks)
CASES = [(10, 2, 16, False, 3), (30, 3, 8, False, 1), (30, 3, 8, True, 4),
         (64, 2, 32, False, 8), (64, 2, 32, True, 2), (24, 2, 128, False, 8)]


@pytest.mark.parametrize("m,lam,block,wide,probes", CASES)
def test_route_route_rerank_rerank_match_jax(rng, m, lam, block, wide,
                                             probes):
    n = 1800
    base, jb, codes, keys, jt, tt = _setup(rng, n, m, lam, block, wide)
    qc, qk = _queries(rng, base, jb, 9)
    tomb = rng.random(n) < 0.05
    jargs = (jt, jnp.asarray(qc), jnp.asarray(qk), jnp.asarray(tomb))
    targs = (tt, coding.words_to_torch(qc), torch.from_numpy(qk),
             torch.from_numpy(tomb))
    jr = jrouting.route(*jargs, probes, 400)
    tr = routing.route(*targs, probes, 400)
    _assert_route_equal(tr, jr)
    assert tr.n_dec is None
    pc_j, pc_t = jnp.asarray(codes), coding.words_to_torch(codes)
    _assert_route_equal(routing.route_rerank(*targs, pc_t, probes, 150),
                        jrouting.route_rerank(*jargs, pc_j, probes, 150))
    _assert_route_equal(routing.rerank(pc_t, targs[1], tr, 120),
                        jrouting.rerank(pc_j, jargs[1], jr, 120))


def test_route_single_query_and_limits_above_pool(rng):
    """Q = 1; limits wider than the probed pool (pads ranked last)."""
    base, jb, codes, keys, jt, tt = _setup(rng, 300, 10, 2, 16, False)
    qc, qk = _queries(rng, base, jb, 1)
    tomb = np.zeros(300, bool)
    jargs = (jt, jnp.asarray(qc), jnp.asarray(qk), jnp.asarray(tomb))
    targs = (tt, coding.words_to_torch(qc), torch.from_numpy(qk),
             torch.from_numpy(tomb))
    _assert_route_equal(routing.route(*targs, 3, 10_000),
                        jrouting.route(*jargs, 3, 10_000))
    _assert_route_equal(
        routing.route_rerank(*targs, coding.words_to_torch(codes), 3, 10_000),
        jrouting.route_rerank(*jargs, jnp.asarray(codes), 3, 10_000))


def test_route_matches_oracle(rng):
    """The reference semantics, independently of both packages."""
    n, block, probes, limit = 400, 16, 3, 200
    base, jb, codes, keys, jt, tt = _setup(rng, n, 10, 2, block, False)
    qc, qk = _queries(rng, base, jb, 12)
    nbits = jb.code_bits

    def bits(words):
        return np.array([(words[p // 32] >> np.uint32(31 - p % 32)) & 1
                         for p in range(nbits)], np.uint8)

    group_parts, group_rep_bits = [], []
    for gi in range(jb.g):
        parts = oracle_partitions(keys[:, gi], np.arange(n), block)
        group_parts.append(parts)
        group_rep_bits.append(np.stack([bits(codes[p["rep_id"], gi])
                                        for p in parts]))
    res = routing.route(tt, coding.words_to_torch(qc), torch.from_numpy(qk),
                        torch.zeros(n, dtype=torch.bool), probes, limit)
    for qi in range(len(qc)):
        expected = oracle_route(group_parts, group_rep_bits,
                                [bits(qc[qi, gi]) for gi in range(jb.g)],
                                qk[qi], max_probes=probes, limit=limit)
        got = [(int(i), int(s)) for i, s in zip(res.ids[qi].tolist(),
                                                res.scores[qi].tolist())
               if i >= 0]
        assert got == expected, f"q={qi}"


@pytest.mark.parametrize("limit", [10, 150, 10_000])
def test_route_rerank_approx_is_refused(rng, limit):
    """``approx=True`` (refused before the port had an approximate top-L)
    equals the JAX package's ``approx=True`` on the CPU, where both select
    exactly; with tombstones, and limits below and above the deduped pool.

    Where the limit covers the whole pool (k equals the row's length)
    XLA:CPU's approx_max_k sorts without keeping the lower index first
    among ties, so there the ids are compared as (score, id) sets, and
    every other field bit for bit."""
    base, jb, codes, keys, jt, tt = _setup(rng, 400, 10, 2, 16, False)
    qc, qk = _queries(rng, base, jb, 5)
    tomb = rng.random(400) < 0.2
    got = routing.route_rerank(tt, coding.words_to_torch(qc),
                               torch.from_numpy(qk), torch.from_numpy(tomb),
                               coding.words_to_torch(codes), 3, limit,
                               approx=True)
    want = jrouting.route_rerank(
        jt, jnp.asarray(qc), jnp.asarray(qk), jnp.asarray(tomb),
        jnp.asarray(codes), 3, limit, approx=True)
    if limit < got.ids.shape[1]:
        _assert_route_equal(got, want)
        return
    _assert_route_equal(got, want, ("scores", "n_unique", "n_raw"))
    for g, w, s in zip(got.ids.numpy(), np.asarray(want.ids),
                       got.scores.numpy()):
        assert sorted(zip(s, g)) == sorted(zip(s, w))


@pytest.mark.parametrize("c", [1, 12, 96])
def test_code_hamming_plain_matches_jax_hamming(rng, c):
    n, q, r = 500, 6, 300
    pc = rng.integers(0, 1 << 32, size=(n, c), dtype=np.uint64) \
        .astype(np.uint32)
    qc = rng.integers(0, 1 << 32, size=(q, c), dtype=np.uint64) \
        .astype(np.uint32)
    ids = rng.integers(-2, n + 3, size=(q, r)).astype(np.int32)
    ids[:, :5] = [-1, n, n + 1, routing.INT32_MAX, 0]      # every pad kind
    got = ch.code_hamming(coding.words_to_torch(pc), coding.words_to_torch(qc),
                          torch.from_numpy(ids))
    ok = (ids >= 0) & (ids < n)
    fine = np.asarray(jhamming.hamming(
        jnp.asarray(qc)[:, None, :], jnp.asarray(pc)[np.where(ok, ids, 0)]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(ok, fine, routing.INT32_MAX))
    # the chunking over queries changes nothing
    old = ch._PLAIN_CHUNK
    try:
        ch._PLAIN_CHUNK = 1
        np.testing.assert_array_equal(
            ch.code_hamming_plain(coding.words_to_torch(pc),
                                  coding.words_to_torch(qc),
                                  torch.from_numpy(ids)).numpy(),
            got.numpy())
    finally:
        ch._PLAIN_CHUNK = old


def test_code_hamming_rejects_what_the_kernel_does_not_take():
    pc = torch.zeros((10, 4), dtype=torch.int32)
    qc = torch.zeros((2, 4), dtype=torch.int32)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        ch.code_hamming(pc.long(), qc.long(), ids)
    with pytest.raises(ValueError):
        ch.code_hamming(pc, torch.zeros((2, 5), dtype=torch.int32), ids)
    with pytest.raises(ValueError):
        ch.code_hamming(pc, qc, torch.zeros((3, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        wide = torch.zeros((10, ch.MAX_C + 1), dtype=torch.int32)
        ch.code_hamming(wide, torch.zeros((2, ch.MAX_C + 1),
                                          dtype=torch.int32), ids)
