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
                              scan_native="off",
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
    # the exact top-L: the default selection is approximate on the card
    # (tests/test_torch_approx_topk_cuda.py) and exact on the CPU
    for fn, kw in ((ths.scan, {}), (ths.scan_chunked, {"chunk": 1024})):
        cpu = fn(ths.build_scan_state(codes, cb), q, tomb, 300, approx=False,
                 anchor=10, margin=40, **kw)
        dev = fn(ths.build_scan_state(codes, cb, device="cuda"), q.cuda(),
                 tomb.cuda(), 300, approx=False, anchor=10, margin=40, **kw)
        for f in FIELDS:
            assert torch.equal(getattr(cpu, f), getattr(dev, f).cpu()), f


def _random_words(rng, n, g, w, cb):
    """uint32 words [n, g, w] holding ``cb`` code bits a group, pad bits
    zero (the packers' contract)."""
    codes = rng.integers(0, 1 << 32, (n, g, w), dtype=np.uint64) \
        .astype(np.uint32)
    pad = w * 32 - cb
    if pad:
        codes[..., -1] &= np.uint32((0xFFFFFFFF << pad) & 0xFFFFFFFF)
    return codes


@pytest.mark.parametrize("w,cb", [(1, 20), (1, 32), (3, 72), (4, 100),
                                  (4, 128)])
@pytest.mark.parametrize("dtype", ["int32", "int64-unsigned",
                                   "int64-signed"])
def test_unpack_device_matches_numpy_for_every_word_dtype(rng, w, cb, dtype):
    """The byte-wide unpack against ``unpack_bits_numpy``, with and without
    pad bits, for int32 bit patterns and for int64 words holding either the
    unsigned value or the sign-extended pattern."""
    codes = _random_words(rng, 70, 3, w, cb)
    words = {"int32": torch.from_numpy(codes.view(np.int32)),
             "int64-unsigned": torch.from_numpy(codes.astype(np.int64)),
             "int64-signed": torch.from_numpy(
                 codes.view(np.int32).astype(np.int64))}[dtype]
    want = ths.unpack_bits_numpy(codes, cb)
    got = ths.unpack_bits_device(words, cb)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ths._popcounts(words, 32).numpy(),
                                  want.sum(axis=1, dtype=np.int32))
    # a leading batch axis, as the query codes of a step have none but a
    # stacked caller may
    np.testing.assert_array_equal(
        ths.unpack_bits_device(words[None], cb).numpy(), want[None])


CHUNK, LIMIT = 128, 60


@pytest.mark.parametrize("packed", [False, True], ids=["bits", "words"])
@pytest.mark.parametrize("tail", [0, 1, LIMIT - 1, LIMIT, CHUNK - 1])
def test_scan_chunked_ragged_tail_matches_scan_and_jax(rng, tail, packed):
    """``n % chunk`` at the edges of the tail rule: a tail of ``k`` rows or
    more is scanned as it is, a shorter one re-reads from ``n - chunk``
    with the overlap masked; every field equals the flat scan's and the JAX
    chunked scan's (which always clamps)."""
    jnp, jhs = _jax()
    n = 3 * CHUNK + tail
    codes, qbits, cb = _mk(rng, n=n, nq=5)
    tomb = np.zeros(n, bool)
    tomb[rng.integers(0, n, 40)] = True
    tomb[n - 3:] = [True, False, True]          # dead rows inside the tail
    kw = dict(anchor=10, margin=8)
    q, tb = torch.from_numpy(qbits), torch.from_numpy(tomb)
    flat = ths.scan(ths.build_scan_state(codes, cb), q, tb, LIMIT, **kw)
    if packed:
        got = ths.scan_chunked(ths.build_scan_state_packed(codes, cb), q, tb,
                               LIMIT, chunk=CHUNK, code_bits=cb, **kw)
        jstate = jhs.build_scan_state_packed(codes, cb)
        jkw = dict(code_bits=cb)
    else:
        got = ths.scan_chunked(ths.build_scan_state(codes, cb), q, tb, LIMIT,
                               chunk=CHUNK, **kw)
        jstate, jkw = jhs.build_scan_state(codes, cb), {}
    for f in FIELDS:
        assert torch.equal(getattr(flat, f), getattr(got, f)), f
    _assert_same(jhs.scan_chunked(jstate, jnp.asarray(qbits),
                                  jnp.asarray(tomb), LIMIT, chunk=CHUNK,
                                  approx=False, **kw, **jkw), got)


def test_scan_chunks_reads_the_tail_once_when_it_can(rng, monkeypatch):
    """The slices the loop hands to ``scan_chunk_merge``: no overlap when
    the tail holds ``k`` rows, the clamped start when it does not."""
    seen = []
    real = ths.scan_chunk_merge

    def spy(qbits, bits_c, popc_c, dead_c, start, start_c, carry, **kw):
        seen.append((start, start_c, bits_c.shape[0]))
        return real(qbits, bits_c, popc_c, dead_c, start, start_c, carry,
                    **kw)

    monkeypatch.setattr(ths, "scan_chunk_merge", spy)
    for tail, want_last in ((LIMIT, (384, 384, LIMIT)),
                            (LIMIT - 1, (384, 384 + LIMIT - 1 - CHUNK,
                                         CHUNK))):
        n = 3 * CHUNK + tail
        codes, qbits, cb = _mk(rng, n=n, nq=2)
        st = ths.build_scan_state(codes, cb)
        seen.clear()
        ths.scan_chunks(st.bits, st.popc, torch.zeros(n, dtype=torch.bool),
                        torch.from_numpy(qbits), LIMIT, CHUNK)
        assert seen[:3] == [(0, 0, CHUNK), (128, 128, CHUNK),
                            (256, 256, CHUNK)]
        assert seen[3] == want_last


# (n, chunk, L) around the approximate tail's rule, W(1,024, 10) = 512 and
# W(4,096, 40) = 2,048: tails of 700 and 513 rows bin as JAX's block, 512
# and 300 rows are exact, 5 (< k) re-reads JAX's block from n - chunk
GEOMETRY = [(3 * 1024 + 700, 1024, 10), (3 * 1024 + 513, 1024, 10),
            (3 * 1024 + 512, 1024, 10), (3 * 1024 + 300, 1024, 10),
            (3 * 1024 + 5, 1024, 10), (2 * 4096 + 3000, 4096, 40)]


@pytest.mark.parametrize("n,chunk,limit", GEOMETRY)
def test_scan_chunks_tail_takes_jaxs_block_geometry(rng, monkeypatch, n,
                                                    chunk, limit):
    """What each block's selection is given, against JAX's loop (block i
    scans ``chunk`` rows from ``start_c = min(i * chunk, n - chunk)``, rows
    below ``start = i * chunk`` DEAD, its bins ``reduction_output_size(
    chunk, k)``): every block bins over the chunk's width, the tail's
    columns at JAX's offset ``start - start_c``, or it is JAX's block."""
    seen = []
    real = ths._select

    def spy(dots, popc, dead, k, row0, approx, width=None):
        seen.append((row0, dots.shape[1], approx, width))
        return real(dots, popc, dead, k, row0, approx, width)

    monkeypatch.setattr(ths, "_select", spy)
    codes, qbits, cb = _mk(rng, n=n, nq=2)
    st = ths.build_scan_state(codes, cb)
    ths.scan_chunks(st.bits, st.popc, torch.zeros(n, dtype=torch.bool),
                    torch.from_numpy(qbits), limit, chunk)
    nc = -(-n // chunk)
    start, start_c = (nc - 1) * chunk, n - chunk        # JAX's tail block
    assert seen[:-1] == [(i * chunk, chunk, True, chunk)
                         for i in range(nc - 1)]
    row0, c, approx, width = seen[-1]
    assert (approx, width, row0 + c) == (True, chunk, n)
    if n - start >= min(limit, chunk):
        assert row0 == start and width - c == start - start_c
    else:
        assert (row0, c) == (start_c, chunk)


def _jax_binned_loop(part, n, chunk, k):
    """JAX's chunked loop in numpy, each block's top-k binned as
    ``approx_topk`` defines it (``rank`` values int64 [Q, n], DEAD at
    tombstones): whole ``chunk``-row blocks, the tail from ``n - chunk``
    with the rows already scanned DEAD, a (score, id) merge."""
    from fspann_tpu_torch.ops.approx_topk import _DEAD, reduction_output_size
    q = part.shape[0]
    w, r = reduction_output_size(chunk, k)
    sc = np.full((q, k), _DEAD, np.int64)
    ids = np.full((q, k), -1, np.int64)
    for i in range(-(-n // chunk)):
        start = i * chunk
        rows = min(start, n - chunk) + np.arange(chunk)
        v = np.where(rows < start, _DEAD, part[:, rows])
        keys = (v << 32) | rows
        if r > 0:
            bins = np.full((q, w), np.iinfo(np.int64).max)
            for qi in range(q):
                np.minimum.at(bins[qi], np.arange(chunk) % w, keys[qi])
            keys = bins
        sel = np.sort(keys, axis=1)[:, :k]
        bsc = sel >> 32
        bid = np.where(bsc < _DEAD, sel & 0xFFFFFFFF, -1)
        msc = np.concatenate([sc, bsc], axis=1)
        mid = np.concatenate([ids, bid], axis=1)
        o = np.argsort((msc << 32) + mid, axis=1, kind="stable")[:, :k]
        sc = np.take_along_axis(msc, o, 1)
        ids = np.take_along_axis(mid, o, 1)
    return sc, ids


@pytest.mark.parametrize("n,chunk,limit", GEOMETRY)
def test_binned_chunked_scan_matches_jaxs_blocks(rng, monkeypatch, n, chunk,
                                                 limit):
    """The card's selection forced on the CPU (``binned_rank_topk`` wherever
    the bins reduce, as ``approx_rank_topk`` runs it on a CUDA tensor):
    ``scan_chunks`` gives the numpy statement of JAX's loop over whole
    blocks, bit for bit."""
    from fspann_tpu_torch.ops import approx_topk as at

    def on_the_card(part, k, row0=0, recall_target=at.RECALL_TARGET, *,
                    popc=None, scale=1, dead=None, width=None):
        c = part.shape[1]
        width = c if width is None else width
        w, r = at.reduction_output_size(width, k, recall_target)
        if r > 0 and c > w:
            return at.binned_rank_topk(part, k, w, r, row0, popc, scale,
                                       dead, width - c)
        return at._smallest(at._rank_keys(part, row0, popc, scale, dead), k)

    monkeypatch.setattr(ths, "approx_rank_topk", on_the_card)
    codes, qbits, cb = _mk(rng, n=n, nq=64)
    tomb = rng.random(n) < 0.05
    st = ths.build_scan_state(codes, cb)
    sc, ids = ths.scan_chunks(st.bits, st.popc, torch.from_numpy(tomb),
                              torch.from_numpy(qbits), limit, chunk)
    dots = qbits.astype(np.int64) @ st.bits.numpy().astype(np.int64).T
    part = np.where(tomb[None, :], 1 << 30,
                    st.popc.numpy()[None, :] - 2 * dots)
    want_sc, want_ids = _jax_binned_loop(part, n, chunk, min(limit, chunk))
    np.testing.assert_array_equal(sc.numpy(), want_sc)
    np.testing.assert_array_equal(ids.numpy(), want_ids)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("n,chunk,limit", GEOMETRY)
def test_scan_chunked_tail_geometry_matches_jax(rng, n, chunk, limit,
                                                approx):
    """The same cases through both packages' ``scan_chunked`` on the CPU,
    where both select exactly: every field bit for bit."""
    jnp, jhs = _jax()
    codes, qbits, cb = _mk(rng, n=n, nq=5)
    tomb = rng.random(n) < 0.05
    kw = dict(anchor=5, margin=8, approx=approx)
    j = jhs.scan_chunked(jhs.build_scan_state(codes, cb), jnp.asarray(qbits),
                         jnp.asarray(tomb), limit, chunk=chunk, **kw)
    t = ths.scan_chunked(ths.build_scan_state(codes, cb),
                         torch.from_numpy(qbits), torch.from_numpy(tomb),
                         limit, chunk=chunk, **kw)
    _assert_same(j, t)


def test_unpack_scratch_is_one_byte_wide(rng):
    """Everything the unpack makes at the size of its input is one byte
    wide, and the packed chunked scan makes no int64 tensor of a chunk's
    word count: recorded with a dispatch mode around the calls."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.made.append((str(func), t.dtype, t.numel()))
            return out

    g, w, cb, chunk = 4, 4, 128, 256
    codes = _random_words(rng, 3 * chunk + 100, g, w, cb)
    words = torch.from_numpy(codes.view(np.int32))[:chunk]
    with Recorder() as rec:
        bits = ths.unpack_bits_device(words, cb)
    assert bits.shape == (chunk, g * cb)
    n_words = chunk * g * w
    big = [m for m in rec.made if m[2] >= n_words]
    assert {m[2] for m in big} >= {n_words * 4, n_words * 32}, big
    wide = [m for m in big if m[1].itemsize != 1]
    assert not wide, f"operands wider than a byte: {wide}"

    qbits = torch.from_numpy(ths.unpack_bits_numpy(codes[:3], cb))
    state = ths.build_scan_state_packed(codes, cb)
    with Recorder() as rec:
        ths.scan_chunked(state, qbits, torch.zeros(len(codes),
                                                   dtype=torch.bool), 50,
                         chunk=chunk, code_bits=cb)
    assert len(rec.made) > 20
    wide = [m for m in rec.made if m[1] == torch.int64 and m[2] >= n_words]
    assert not wide, f"int64 tensors of a chunk's size: {wide}"
    wide = [m for m in rec.made if m[1].itemsize != 1
            and m[2] >= n_words * 4]
    assert not wide, f"byte-count tensors wider than a byte: {wide}"
