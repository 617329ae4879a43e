"""Port's Hamming scan (fspann_tpu_torch/ops/hamming_scan.py) against the JAX
package's exact scan (``approx=False``, its XLA path on the CPU).

``ids``, ``scores``, ``n_unique`` (n_live), ``n_raw`` and ``n_dec`` must be
bit-identical: the scores are integers and the order is (score, id).
Mirrors tests/test_hamming_scan.py, tests/test_scan_capacity.py and
tests/test_adaptive_decrypt.py.

The JAX references are imported on first use (``_jax``), so the
``cuda``-marked test also runs on a GPU host without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops import hamming_scan as ths

torch.set_num_threads(1)

FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")


def _jax():
    import jax.numpy as jnp

    from fspann_tpu.ops import hamming_scan
    return jnp, hamming_scan


def _mk(rng, n=500, d=24, m=10, lam=2, tables=2, divisions=2, nq=9):
    """Codes from one bank (the port's; only the codes matter here)."""
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = rng.normal(size=(nq, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m, lam, tables,
                                         divisions, 3)
    codes, _ = coding.encode_numpy(base, bank)
    qcodes, _ = coding.encode_numpy(queries, bank)
    return codes, ths.unpack_bits_numpy(qcodes, bank.code_bits), \
        bank.code_bits


def _assert_same(j, t):
    for f in FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
        assert b.dtype == torch.int32, f


def _both(codes, qbits, cb, tomb, limit, chunk=None, **kw):
    jnp, jhs = _jax()
    jstate = jhs.build_scan_state(codes, cb)
    tstate = ths.build_scan_state(codes, cb)
    if chunk is None:
        j = jhs.scan(jstate, jnp.asarray(qbits), jnp.asarray(tomb), limit,
                     approx=False, **kw)
        t = ths.scan(tstate, torch.from_numpy(qbits), torch.from_numpy(tomb),
                     limit, **kw)
    else:
        j = jhs.scan_chunked(jstate, jnp.asarray(qbits), jnp.asarray(tomb),
                             limit, chunk=chunk, approx=False, **kw)
        t = ths.scan_chunked(tstate, torch.from_numpy(qbits),
                             torch.from_numpy(tomb), limit, chunk=chunk, **kw)
    return j, t


def test_unpack_and_popcount_match_numpy(rng):
    _, jhs = _jax()
    codes, _, cb = _mk(rng, n=300)
    want = jhs.unpack_bits_numpy(codes, cb)
    np.testing.assert_array_equal(ths.unpack_bits_numpy(codes, cb), want)
    words = torch.from_numpy(codes.astype(np.int64))
    got = ths.unpack_bits_device(words, cb)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    st = ths.build_scan_state(codes, cb, chunk=128)   # 3 chunks, ragged tail
    np.testing.assert_array_equal(st.bits.numpy(), want)
    np.testing.assert_array_equal(
        st.popc.numpy(), np.asarray(jhs.build_scan_state(codes, cb).popc))
    np.testing.assert_array_equal(st.popc.numpy(),
                                  want.sum(axis=1, dtype=np.int32))


def test_unpack_full_words_msb_first():
    """Every bit position of a full 32-bit word, high bit set included."""
    _, jhs = _jax()
    codes = np.array([[[0x80000001, 0xFFFFFFFF]], [[0x7FFFFFFE, 0x1]]],
                     np.uint32)
    want = jhs.unpack_bits_numpy(codes, 64)
    st = ths.build_scan_state(codes, 64)
    np.testing.assert_array_equal(st.bits.numpy(), want)
    np.testing.assert_array_equal(st.popc.numpy(), [34, 31])


@pytest.mark.parametrize("nq", [1, 7, 64])
def test_scan_matches_jax(rng, nq):
    codes, qbits, cb = _mk(rng, n=400, nq=nq)
    tomb = np.zeros(400, bool)
    tomb[rng.integers(0, 400, 25)] = True
    j, t = _both(codes, qbits, cb, tomb, 50, anchor=10, margin=6)
    _assert_same(j, t)


def test_scan_tie_heavy_matches_jax(rng):
    """4-bit codes: a handful of distinct scores over 600 rows, so the
    top-L cut lands inside long runs of ties — (score, id) order decides."""
    codes, qbits, cb = _mk(rng, n=600, m=2, lam=1, tables=2, divisions=1,
                           nq=7)
    tomb = np.zeros(600, bool)
    tomb[::11] = True
    j, t = _both(codes, qbits, cb, tomb, 150)
    _assert_same(j, t)
    assert (t.scores.numpy()[:, :-1] <= t.scores.numpy()[:, 1:]).all()


def test_scan_limit_above_rows_and_all_dead_tail(rng):
    codes, qbits, cb = _mk(rng, n=120, nq=5)
    tomb = np.ones(120, bool)
    tomb[:30] = False
    j, t = _both(codes, qbits, cb, tomb, 500, anchor=50, margin=4)
    _assert_same(j, t)
    assert ((t.ids.numpy() >= 0).sum(axis=1) == 30).all()
    assert (t.scores.numpy()[:, 30:] == np.iinfo(np.int32).max).all()


@pytest.mark.parametrize("n,chunk,nq", [(700, 256, 7), (700, 96, 1),
                                        (512, 128, 64), (300, 1024, 3)])
def test_scan_chunked_matches_jax(rng, n, chunk, nq):
    """Chunk tails (the last block re-reads overlap rows) and the n <= chunk
    fallback give JAX's answer bit for bit."""
    codes, qbits, cb = _mk(rng, n=n, nq=nq)
    tomb = np.zeros(n, bool)
    tomb[rng.integers(0, n, 30)] = True
    j, t = _both(codes, qbits, cb, tomb, 60, chunk=chunk, anchor=10, margin=8)
    _assert_same(j, t)
    flat = ths.scan(ths.build_scan_state(codes, cb), torch.from_numpy(qbits),
                    torch.from_numpy(tomb), 60, anchor=10, margin=8)
    for f in FIELDS:
        assert torch.equal(getattr(flat, f), getattr(t, f)), f


def test_scan_respects_tombstones(rng):
    codes, qbits, cb = _mk(rng, n=300, nq=3)
    st = ths.build_scan_state(codes, cb)
    q = torch.from_numpy(qbits)
    res0 = ths.scan(st, q, torch.zeros(300, dtype=torch.bool), 40)
    dead = [int(x) for x in res0.ids[0] if x >= 0][:10]
    tomb = torch.zeros(300, dtype=torch.bool)
    tomb[dead] = True
    res1 = ths.scan(st, q, tomb, 40)
    assert not ({int(x) for x in res1.ids[0] if x >= 0} & set(dead))


def test_n_dec_matches_oracle_and_is_monotone(rng):
    codes, qbits, cb = _mk(rng, n=400, nq=6)
    st = ths.build_scan_state(codes, cb)
    q, tomb = torch.from_numpy(qbits), torch.zeros(400, dtype=torch.bool)
    limit, anchor = 80, 10
    prev = None
    for margin in (2, 8, 32, 1000):
        res = ths.scan(st, q, tomb, limit, anchor=anchor, margin=margin)
        scores, n_dec = res.scores.numpy(), res.n_dec.numpy()
        for qi in range(6):
            want = int((scores[qi] <= scores[qi, anchor - 1] + margin).sum())
            assert n_dec[qi] == min(max(want, anchor), limit)
        if prev is not None:
            assert (n_dec >= prev).all()
        prev = n_dec
    assert (prev == limit).all()
    floored = ths.scan(st, q, tomb, limit, anchor=anchor, margin=1, floor=50)
    assert (floored.n_dec.numpy() >= 50).all()
    assert ths.scan(st, q, tomb, limit).n_dec is None


def _index_cfg(capacity, margin=0):
    from fspann_tpu_torch.config import (EvalConfig, PaperConfig,
                                         RuntimeConfig, SystemConfig)
    return SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=400, max_global_candidates=400,
                              routing_mode="scan", encode_backend="cpu",
                              rerank_limit=100, scan_packed="off",
                              scan_capacity_rows=capacity,
                              adaptive_decrypt_margin=margin),
        eval=EvalConfig(k_variants=(1, 10))).validate()


@pytest.mark.parametrize("margin", [0, 12])
def test_capacity_padding_matches_exact_fit(rng, margin):
    """A capacity-padded state (padding tombstoned) routes exactly like the
    exact-fit state, and like the JAX index with the same padding."""
    from fspann_tpu.config import (EvalConfig as JE, PaperConfig as JP,
                                   RuntimeConfig as JR, SystemConfig as JS)
    from fspann_tpu.index.service import PartitionedIndex as JIndex
    from fspann_tpu_torch.api.convert import bank_from_jax
    from fspann_tpu_torch.index.service import PartitionedIndex

    n, dim = 900, 16
    base = rng.normal(size=(n, dim)).astype(np.float32) * 3
    queries = base[:6] + 0.01
    jcfg = JS(paper=JP(m=8, lam=2, divisions=2, tables=3, seed=13),
              runtime=JR(refinement_limit=400, max_global_candidates=400,
                         routing_mode="scan", encode_backend="cpu",
                         rerank_limit=100, scan_packed="off",
                         scan_native="off", scan_capacity_rows=n + 256,
                         adaptive_decrypt_margin=margin),
              eval=JE(k_variants=(1, 10))).validate()
    jidx = JIndex(jcfg, dim)
    jidx.stage(np.arange(n), base)
    jidx.finalize()
    jidx.mark_deleted([3, 500])
    jb = jidx.bank
    bank = bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                         np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                         jb.divisions, jb.seed)
    out = []
    for cap in (n + 256, 0):
        idx = PartitionedIndex(_index_cfg(cap, margin), dim, device="cpu")
        idx.set_bank(bank)
        idx.stage(np.arange(n), base)
        idx.finalize()
        idx.mark_deleted([3, 500])
        assert idx._scan_state.bits.shape[0] == (cap or n)
        assert idx._scan_rows == (cap or n)
        qc, qk = idx.encode_queries(queries)
        out.append(idx.route_batch(qc, qk))
    pad, fit = out
    jq = jidx.encode_queries(queries)
    jres = jidx.route_batch(*jq)
    for f in ("ids", "scores", "n_unique", "n_dec"):
        a, b = getattr(pad, f), getattr(fit, f)
        if a is None:
            assert b is None and margin == 0
            continue
        assert torch.equal(a, b), f
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      a.numpy(), err_msg=f)
    # n_raw counts the scanned rows, padding included — as in JAX
    np.testing.assert_array_equal(np.asarray(jres.n_raw), pad.n_raw.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 7, 64])
def test_scan_cuda_matches_cpu(nq):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(nq)
    codes, qbits, cb = _mk(rng, n=4001, m=64, lam=2, tables=2, divisions=3,
                           nq=nq)
    tomb = torch.from_numpy(rng.random(4001) < 0.05)
    q = torch.from_numpy(qbits)
    for fn, kw in ((ths.scan, {}), (ths.scan_chunked, {"chunk": 1024})):
        cpu = fn(ths.build_scan_state(codes, cb), q, tomb, 300, anchor=10,
                 margin=40, **kw)
        dev = fn(ths.build_scan_state(codes, cb, device="cuda"), q.cuda(),
                 tomb.cuda(), 300, anchor=10, margin=40, **kw)
        for f in FIELDS:
            assert torch.equal(getattr(cpu, f), getattr(dev, f).cpu()), f
