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
                                query_batch=BATCH)
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
    tg = tgt.precompute(base, queries, k=10, backend="torch")
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
    """No table checkpoint in the port yet: restore decrypts and re-encodes
    with the persisted bank (alpha included), and serves the same results."""
    _, ts, base, queries, root = pair
    before = [[(r.id, r.distance) for r in ts.search(ts.create_token(q, 10))]
              for q in queries[:4]]
    ts.flush_all()
    back = ForwardSecureANNSystem(_cfg(tconfig), str(root / "torch"), D,
                                  query_batch=BATCH)
    try:
        assert back.restore_index_from_disk() == N
        np.testing.assert_array_equal(back.index.bank.alpha,
                                      ts.index.bank.alpha)
        after = [[(r.id, r.distance)
                  for r in back.search(back.create_token(q, 10))]
                 for q in queries[:4]]
        assert after == before
    finally:
        back.shutdown()


def test_unported_modes_raise(tmp_path):
    import dataclasses

    cfg = _cfg(tconfig)
    for kw in ({"routing_mode": "probe"}, {"encode_backend": "default"},
               {"refine_backend": "device"}, {"scan_packed": "on"},
               {"scan_native": "on"}):
        bad = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, **kw))
        with pytest.raises(NotImplementedError):
            ForwardSecureANNSystem(bad, str(tmp_path / "x"), D)


def test_jax_bank_file_is_refused(pair):
    """A JAX bank.npz stores (omega, r) and the seed, not alpha; the port
    cannot regenerate threefry's alpha, so it refuses the file instead of
    encoding with a different bank."""
    from fspann_tpu_torch.index.service import PartitionedIndex

    _, _, _, _, root = pair
    with pytest.raises(ValueError, match="bank_from_jax"):
        PartitionedIndex(_cfg(tconfig), D,
                         bank_path=str(root / "jax" / "bank.npz"))
