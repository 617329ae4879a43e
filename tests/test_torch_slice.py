"""The port's encrypted scan-query slice against the JAX facade, end to end,
on the CPU at a small size (3k x 16, 48-bit codes, L=200, margin 40, f16
payloads, host encode, query batch 16).

Both systems hold the same bank (the JAX bank carried across with
``bank_from_jax``), so codes, scan routes and the decrypt set are equal
bit for bit.  Both score candidates with the same C decrypt-and-score
kernel, so distances agree to float32 round-off (checked at 1e-6
relative)."""

import numpy as np
import pytest
import torch

from fspann_tpu import config as jconfig
from fspann_tpu.api.system import ForwardSecureANNSystem as JaxSystem
from fspann_tpu.io import groundtruth as jgt
from fspann_tpu.io import synthetic
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.io import groundtruth as tgt

torch.set_num_threads(1)

N, D, NQ, BATCH = 3000, 16, 48, 16


def _cfg(c):
    return c.SystemConfig(
        paper=c.PaperConfig(m=8, lam=2, divisions=3, tables=1, seed=13),
        runtime=c.RuntimeConfig(refinement_limit=200,
                                max_global_candidates=200,
                                routing_mode="scan", encode_backend="cpu",
                                adaptive_decrypt_margin=40,
                                storage_dtype="f16", scan_native="off"),
        eval=c.EvalConfig(k_variants=(1, 10))).validate()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    base, queries = synthetic.lsh_hard_corpus(N, D, NQ, seed=7)
    js = JaxSystem(_cfg(jconfig), str(root / "jax"), D, query_batch=BATCH)
    js.index_stream(base, batch_size=1000)
    js.finalize_for_search()
    jb = js.index.bank
    ts = ForwardSecureANNSystem(_cfg(tconfig), str(root / "torch"), D,
                                query_batch=BATCH, device="cpu")
    ts.index.set_bank(bank_from_jax(
        np.asarray(jb.alpha), np.asarray(jb.r), np.asarray(jb.omega), jb.m,
        jb.lam, jb.tables, jb.divisions, jb.seed))
    ts.index_stream(base, batch_size=1000)
    ts.finalize_for_search()
    yield js, ts, base, queries, root
    js.shutdown()
    ts.shutdown()


def test_route_per_batch_is_bit_identical(pair):
    js, ts, base, queries, _ = pair
    assert ts.index.max_route_id() == js.index.max_route_id() == N - 1
    for s in range(0, NQ, BATCH):
        jq = js.index.encode_queries(queries[s:s + BATCH])
        tq = ts.index.encode_queries(queries[s:s + BATCH])
        np.testing.assert_array_equal(tq[0], np.asarray(jq[0]))
        jr = js.index.route_batch(*jq)
        tr = ts.index.route_batch(*tq)
        for f in ("ids", "scores", "n_unique", "n_raw", "n_dec"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                          getattr(tr, f).numpy(), err_msg=f)


def test_final_results_and_recall_match(pair):
    js, ts, base, queries, _ = pair
    jg = jgt.precompute(base, queries, k=10)
    tg = tgt.precompute(base, queries, k=10, backend="torch", device="cpu")
    # GT ids equal except where distances tie
    d = np.linalg.norm(base[jg.gt] - queries[:, None, :], axis=-1)
    untied = np.ones_like(d, bool)
    close = np.isclose(d[:, 1:], d[:, :-1], rtol=2e-4, atol=1e-4)
    untied[:, 1:] &= ~close
    untied[:, :-1] &= ~close
    np.testing.assert_array_equal(tg.gt[untied], jg.gt[untied])

    jtok = [js.tokens.create_batch(queries[s:s + BATCH], 10)
            for s in range(0, NQ, BATCH)]
    ttok = [ts.tokens.create_batch(queries[s:s + BATCH], 10)
            for s in range(0, NQ, BATCH)]
    for a, b in zip(js.query_service.search_batches(jtok),
                    ts.query_service.search_batches(ttok)):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-6)
        assert [s.cand_decrypted for s in b.stats] == \
            [s.cand_decrypted for s in a.stats]

    ja = js.run_queries(queries, jg, base)
    ta = ts.run_queries(queries, tg, base)
    assert ta.recall_at_k == pytest.approx(ja.recall_at_k)
    assert ta.ratio_at_k == pytest.approx(ja.ratio_at_k, rel=1e-6)
    assert ta.mean_cand_decrypted == ja.mean_cand_decrypted
    assert ta.recall_at_k[10] > 0.5


def test_delete_and_undelete_match(pair):
    js, ts, base, queries, _ = pair
    q = base[42] + 0.001
    for s in (js, ts):
        assert s.search(s.create_token(q, 1))[0].id == 42
        s.delete([42])
        assert s.search(s.create_token(q, 1))[0].id != 42
    assert [r.id for r in ts.search(ts.create_token(q, 10))] == \
        [r.id for r in js.search(js.create_token(q, 10))]
    for s in (js, ts):
        assert s.undelete([42]) == [42]
        assert s.search(s.create_token(q, 1))[0].id == 42


def test_restore_rebuilds_identical_index(pair):
    """Restore loads the table checkpoint written at finalize (scan mode
    keeps the packed codes in it) with the persisted bank (alpha included),
    and serves the same results."""
    _, ts, base, queries, root = pair
    before = [[(r.id, r.distance) for r in ts.search(ts.create_token(q, 10))]
              for q in queries[:4]]
    ts.flush_all()
    back = ForwardSecureANNSystem(_cfg(tconfig), str(root / "torch"), D,
                                  query_batch=BATCH, device="cpu")
    try:
        assert back.restore_index_from_disk() == N
        assert back.index._table_host is not None      # the fast path
        np.testing.assert_array_equal(back.index._scan_codes,
                                      ts.index._scan_codes)
        np.testing.assert_array_equal(back.index.bank.alpha,
                                      ts.index.bank.alpha)
        after = [[(r.id, r.distance)
                  for r in back.search(back.create_token(q, 10))]
                 for q in queries[:4]]
        assert after == before
    finally:
        back.shutdown()


def test_jax_scan_table_npz_restores_in_port(pair):
    """A JAX scan-mode table.npz (table + packed codes) loads unchanged and
    the restored scan routes like the JAX index."""
    from fspann_tpu_torch.index.service import PartitionedIndex

    js, ts, base, queries, root = pair
    idx = PartitionedIndex(_cfg(tconfig), D, device="cpu")
    idx.set_bank(ts.index.bank)
    assert idx.load_table(str(root / "jax" / "table.npz"), expect_rows=N)
    jq = js.index.encode_queries(queries[:BATCH])
    jr = js.index.route_batch(*jq)
    tr = idx.route_batch(*(np.asarray(a) for a in jq))
    for f in ("ids", "scores", "n_unique", "n_raw", "n_dec"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)


@pytest.mark.parametrize("mode", ["scan_packed", "scan_native",
                                  "append_rows"])
def test_formerly_unported_modes_serve(pair, mode):
    """The packed scan state, the native host scan and live insert serve,
    and route like the JAX index built with the same mode."""
    import dataclasses

    from fspann_tpu.index.service import PartitionedIndex as JIndex
    from fspann_tpu_torch.index.service import PartitionedIndex

    js, ts, base, queries, _ = pair
    on = {"scan_packed": {"scan_packed": "on"},
          "scan_native": {"scan_native": "on"},
          "append_rows": {}}[mode]
    idx = []
    for c, cls, kw in ((jconfig, JIndex, {}),
                       (tconfig, PartitionedIndex, {"device": "cpu"})):
        cfg = _cfg(c)
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, **on))
        ix = cls(cfg, D, **kw)
        if cls is PartitionedIndex:
            ix.set_bank(ts.index.bank)
        else:
            ix.bank = js.index.bank
        ix.stage(np.arange(N - 200), base[:N - 200])
        ix.finalize()
        if mode == "append_rows":
            ix.append_rows(np.arange(N - 200, N), base[N - 200:])
        ix.mark_deleted([5, N - 3])
        idx.append(ix)
    jidx, tidx = idx
    if mode == "scan_packed":
        from fspann_tpu_torch.ops.hamming_scan import PackedScanState
        assert isinstance(tidx._scan_state, PackedScanState)
        assert tidx._scan_state.words.dtype == torch.int32
    if mode == "scan_native":
        assert tidx._scan_state is None and jidx._scan_state is None
    jq = jidx.encode_queries(queries[:BATCH])
    jr = jidx.route_batch(*jq)
    tr = tidx.route_batch(*tidx.encode_queries(queries[:BATCH]))
    for f in ("ids", "scores", "n_unique", "n_raw", "n_dec"):
        got = getattr(tr, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(getattr(jr, f)),
                                      err_msg=f)


def test_jax_store_reopens_in_port_and_serves_jax_ids(pair, tmp_path):
    """A store the JAX package wrote (``bank.npz`` without alpha,
    ``table.npz``, keystore, ciphertexts) reopens in the port: alpha
    regenerates from the seed bit for bit, and the restored system serves
    the JAX package's ids (distances to float32 round-off, 1e-6)."""
    import shutil

    js, _, _, queries, root = pair
    js.flush_all()
    shutil.copytree(root / "jax", tmp_path / "jax")
    with np.load(tmp_path / "jax" / "bank.npz") as z:
        assert "alpha" not in z.files
    back = ForwardSecureANNSystem(_cfg(tconfig), str(tmp_path / "jax"), D,
                                  query_batch=BATCH, device="cpu")
    try:
        jb, tb = js.index.bank, back.index.bank
        for f in ("alpha", "r", "omega"):
            np.testing.assert_array_equal(
                getattr(tb, f).view(np.uint32),
                np.asarray(getattr(jb, f)).view(np.uint32), err_msg=f)
        assert back.restore_index_from_disk() == N
        for s in range(0, NQ, BATCH):
            jr = js.query_service.search_batch(
                js.tokens.create_batch(queries[s:s + BATCH], 10))
            tr = back.query_service.search_batch(
                back.tokens.create_batch(queries[s:s + BATCH], 10))
            np.testing.assert_array_equal(tr.ids, jr.ids)
            np.testing.assert_allclose(tr.distances, jr.distances,
                                       rtol=1e-6)
    finally:
        back.shutdown()
