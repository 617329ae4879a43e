"""The port against the JAX package at the geometry of the JAX package's two
largest served points (``chip_smoke.py`` phases 18 and 19 run them at full
scale on the card), on the CPU at small sizes.

* The 960-d point (m 128: 24 groups x 256 bits = 6,144-bit codes, L 4,000,
  margin 72, f16 payloads, host encode, batch 64) through both facades on
  8,192 rows of ``lsh_hard_corpus``: each builds its own bank from the
  sample, and the banks are equal bit for bit; every batch's route is
  equal on every field; the final ids are equal and the distances agree
  to 1e-6 relative (both score with the same C decrypt-and-score kernel).
* The selection's binning at r = 5 and r = 6 (10M rows at L 2,000 bin 64
  rows a bin): the reduction sizes equal XLA's, and the plain twin and
  ``binned_rank_topk`` equal a numpy statement of the definition.
* The chunked scan over 20 chunks and a ragged tail (10M rows are 19
  chunks of 2^19 and a tail) with ``approx=False`` equals the JAX
  package's, on bits and on packed words.
* The layout decisions: "auto" packing and ``route_batch``'s flat or
  chunked scan at the two points' row counts and widths, with the free
  memory of an 80 GB card given to both packages alike.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fspann_tpu import config as jconfig
from fspann_tpu.api.system import ForwardSecureANNSystem as JaxSystem
from fspann_tpu.index import service as jservice
from fspann_tpu.io import synthetic
from fspann_tpu.ops import hamming_scan as jhs
from fspann_tpu.utils import devmem as jdevmem
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.index import service as tservice
from fspann_tpu_torch.ops import approx_topk as at
from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.ops import hamming_scan as ths
from fspann_tpu_torch.ops.routing import RouteResult
from fspann_tpu_torch.utils import devmem as tdevmem

torch.set_num_threads(1)

FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")
N, D, NQ, BATCH = 8192, 960, 64, 64


def _cfg(c, m=128, limit=4000, margin=72, **runtime):
    """bench.py's scan profile at the 960-d point's m, L and margin."""
    return c.SystemConfig(
        paper=c.PaperConfig(m=m, lam=2, divisions=3, tables=8, seed=13),
        runtime=c.RuntimeConfig(
            refinement_limit=56_000, max_global_candidates=56_000,
            rerank_limit=limit, adaptive_decrypt_margin=margin,
            probe_override=16, block_size=128, routing_mode="scan",
            encode_backend="cpu", storage_dtype="f16",
            **{"scan_native": "off", **runtime}),
        eval=c.EvalConfig(k_variants=(1, 10, 100))).validate()


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    root = tmp_path_factory.mktemp("wide")
    base, queries = synthetic.lsh_hard_corpus(N, D, NQ, seed=42)
    js = JaxSystem(_cfg(jconfig), str(root / "jax"), D, query_batch=BATCH)
    ts = ForwardSecureANNSystem(_cfg(tconfig), str(root / "torch"), D,
                                query_batch=BATCH, device="cpu")
    for s in (js, ts):
        s.index_stream(base, batch_size=4096)
        s.finalize_for_search()
    yield js, ts, base, queries
    js.shutdown()
    ts.shutdown()


def test_wide_point_sample_bank_equals_jax(wide):
    js, ts, _, _ = wide
    jb, tb = js.index.bank, ts.index.bank
    assert tb.code_bits * tb.g == 6144
    for f in ("alpha", "r", "omega"):
        np.testing.assert_array_equal(getattr(tb, f),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def test_wide_point_route_per_batch_equals_jax(wide):
    js, ts, _, queries = wide
    for s in range(0, NQ, BATCH):
        jq = js.index.encode_queries(queries[s:s + BATCH])
        tq = ts.index.encode_queries(queries[s:s + BATCH])
        np.testing.assert_array_equal(tq[0], np.asarray(jq[0]))
        jr, tr = js.index.route_batch(*jq), ts.index.route_batch(*tq)
        assert tr.ids.shape == (BATCH, 4000)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f)


def test_wide_point_final_results_equal_jax(wide):
    js, ts, _, queries = wide
    toks = [[s.tokens.create_batch(queries[i:i + BATCH], 100)
             for i in range(0, NQ, BATCH)] for s in (js, ts)]
    for a, b in zip(js.query_service.search_batches(toks[0]),
                    ts.query_service.search_batches(toks[1])):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-6)
        assert [s.cand_decrypted for s in b.stats] == \
            [s.cand_decrypted for s in a.stats]


def _numpy_binned(v, k, w, row0=0):
    """The selection's definition in numpy: key (v << 32) | row, element i
    in bin i mod w, each bin's least key, the exact top-k of the bins."""
    keys = (v.astype(np.int64) << 32) | (row0 + np.arange(v.shape[1]))
    out = np.empty((len(v), k), np.int64)
    for qi in range(len(v)):
        best = np.full(w, np.iinfo(np.int64).max)
        np.minimum.at(best, np.arange(v.shape[1]) % w, keys[qi])
        out[qi] = np.sort(best)[:k]
    return (out >> 32).astype(np.int32), (out & 0xFFFFFFFF).astype(np.int32)


@pytest.mark.parametrize("n,k,want", [(100_000, 40, (3_200, 5)),
                                      (200_000, 40, (3_200, 6)),
                                      (10_000_000, 2_000, (156_288, 6)),
                                      (1_000_000, 4_000, (250_112, 2)),
                                      (10_065_536, 2_000, (157_312, 6))])
def test_reduction_at_r5_r6_and_the_points_matches_xla(n, k, want):
    # XLA's own sizing sits in a private module: imported here, so that a
    # JAX upgrade that moves it fails this case alone
    from jax._src.lib import _jax

    assert at.reduction_output_size(n, k) == want
    assert tuple(_jax.approx_top_k_reduction_output_size(
        n, 2, k, at.RECALL_TARGET, False, -1)) == want


@pytest.mark.parametrize("n,k", [(100_000, 40), (200_000, 40)])
def test_binning_at_r5_and_r6_matches_numpy_definition(n, k):
    """Few distinct values (long runs of ties inside and across bins), dead
    rows and a row offset, as the scan's epilogue forms them."""
    rng = np.random.default_rng(n)
    w, r = at.reduction_output_size(n, k)
    assert r in (5, 6)
    x = rng.integers(0, 50, (3, n)).astype(np.int32)
    popc = rng.integers(40, 120, n).astype(np.int32)
    dead = rng.random(n) < 0.05
    v = np.where(dead[None, :], 1 << 30, popc[None, :] - 2 * x)
    want = _numpy_binned(v, k, w, row0=9_000)
    epi = dict(popc=torch.from_numpy(popc), scale=-2,
               dead=torch.from_numpy(dead))
    xt = torch.from_numpy(x)
    bins = at.partial_reduce_plain(xt, w, r, 9_000, **epi)
    assert torch.equal(at.partial_reduce(xt, w, r, 9_000, **epi), bins)
    for got in (at._smallest(bins, k),
                at.binned_rank_topk(xt, k, w, r, 9_000, **epi)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


def _codes(rng, n, nq):
    base = rng.normal(size=(n, 24)).astype(np.float32) * 4
    queries = rng.normal(size=(nq, 24)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], 10, 2, 2, 2, 3)
    codes, _ = coding.encode_numpy(base, bank)
    qcodes, _ = coding.encode_numpy(queries, bank)
    return codes, ths.unpack_bits_numpy(qcodes, bank.code_bits), \
        bank.code_bits


CHUNK, LIMIT = 128, 60


@pytest.mark.parametrize("packed", [False, True], ids=["bits", "words"])
@pytest.mark.parametrize("tail", [37, 90])
def test_scan_chunked_over_20_chunks_and_a_tail_matches_jax(packed, tail):
    """20 whole chunks, then a tail shorter than L (re-read from n - chunk,
    the scanned rows masked) or longer (scanned as it is)."""
    rng = np.random.default_rng(tail)
    n = 20 * CHUNK + tail
    codes, qbits, cb = _codes(rng, n, 7)
    tomb = rng.random(n) < 0.02
    kw = dict(anchor=10, margin=8)
    build = (ths.build_scan_state_packed, jhs.build_scan_state_packed) \
        if packed else (ths.build_scan_state, jhs.build_scan_state)
    extra = dict(code_bits=cb) if packed else {}
    got = ths.scan_chunked(build[0](codes, cb), torch.from_numpy(qbits),
                           torch.from_numpy(tomb), LIMIT, chunk=CHUNK,
                           approx=False, **kw, **extra)
    want = jhs.scan_chunked(build[1](codes, cb), jnp.asarray(qbits),
                            jnp.asarray(tomb), LIMIT, chunk=CHUNK,
                            approx=False, **kw, **extra)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# what torch.cuda.mem_get_info reports free on an idle H100 80GB HBM3
FREE_80GB = 84_540_309_504


def _decisions(monkeypatch, pkg, rows, m, packed_mode):
    """(layout, scan) that ``pkg``'s index takes for ``rows`` rows at m
    projections a group, on a card with FREE_80GB free before the state is
    built and that less the state's bytes after."""
    cfg_mod, service, hs, devmem = pkg
    seen, used = [], [0]

    def budget(numerator, denominator, fallback, floor=256 << 20,
               device=None):
        return max((FREE_80GB - used[0]) * numerator // denominator, floor)

    monkeypatch.setattr(devmem, "free_memory_budget", budget)
    for name, layout in (("build_scan_state", "unpacked"),
                         ("build_scan_state_packed", "packed")):
        monkeypatch.setattr(hs, name, lambda *_a, _l=layout, **_k: _l)
    for name in ("scan", "scan_chunked"):
        def scan(_state, qbits, *_a, _name=name, **_k):
            seen.append(_name)
            z = np.zeros((qbits.shape[0], 1), np.int32)
            return RouteResult(z, z, z[:, 0], z[:, 0], None)
        monkeypatch.setattr(hs, name, scan)
    cfg = _cfg(cfg_mod, m=m, scan_packed=packed_mode)
    idx = service.PartitionedIndex(cfg, 96, **(
        {"device": "cpu"} if service is tservice else {}))
    g, w = cfg.paper.num_groups, cfg.paper.code_words
    codes = np.broadcast_to(np.zeros((1, g, w), np.uint32), (rows, g, w))
    layout = idx._make_scan_state(codes)
    seen.append(layout)
    used[0] = rows * g * (cfg.paper.code_bits if layout == "unpacked"
                          else 4 * w)
    if layout == "packed":          # route_batch tells the layouts apart
        idx._scan_state = hs.PackedScanState(None, None)
    else:
        idx._scan_state = hs.ScanState(None, None)
    idx.table, idx.frozen, idx._dense, idx._n_rows = object(), True, True, \
        rows
    qcodes = np.zeros((64, g, w), np.uint32)
    idx.route_batch(qcodes, np.zeros((64, g), np.int64))
    return tuple(seen)


@pytest.mark.parametrize("rows,m,mode,want", [
    (1_000_000, 128, "auto", ("unpacked", "scan")),        # the 960-d point
    (10_000_000, 64, "auto", ("unpacked", "scan")),        # 10M x 96
    (10_065_536, 64, "on", ("packed", "scan_chunked")),    # its restore
    (20_000_000, 64, "auto", ("packed", "scan_chunked")),
    (25_000_000, 64, "off", ("unpacked", "scan_chunked"))])
def test_layout_decisions_match_jax_on_an_80gb_card(monkeypatch, rows, m,
                                                    mode, want):
    got = [_decisions(monkeypatch, pkg, rows, m, mode) for pkg in (
        (jconfig, jservice, jhs, jdevmem),
        (tconfig, tservice, ths, tdevmem))]
    assert got[0] == got[1] == want
