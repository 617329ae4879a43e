"""The port's mirror of the system half of ``tests/test_adaptive_decrypt.py``
(the per-query decrypt budget of scan mode; its device half is mirrored in
``tests/test_torch_hamming_scan.py``).

One JAX system and one port system (``device="cpu"``) serve the same
20,000 x 32 LSH-hard corpus on the JAX store's bank (``torch_mirror``); at
every margin the two runs' aggregates agree: recall and mean decrypted
exactly, ratios within 1e-5 relative, and the retried and returned counts
of every query row equal.  The JAX tests' own assertions hold on the port's
side."""

import dataclasses

import numpy as np
import pytest

from fspann_tpu.io import groundtruth as jgt
from fspann_tpu.io import synthetic
from fspann_tpu_torch.io import groundtruth as tgt
from torch_mirror import assert_same_aggregates, built_pair


def _cfg(c):
    return c.SystemConfig(
        paper=c.PaperConfig(m=12, lam=2, divisions=2, tables=4, seed=13),
        runtime=c.RuntimeConfig(block_size=64, encode_backend="cpu",
                                refinement_limit=8_000,
                                max_global_candidates=8_000,
                                rerank_limit=1_000, routing_mode="scan"),
        eval=c.EvalConfig(k_variants=(1, 10, 100))).validate()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    n, d = 20_000, 32
    base, queries = synthetic.lsh_hard_corpus(n, d, 32, seed=5)
    js, ts = built_pair(_cfg, tmp_path_factory.mktemp("adapt"), d, base,
                        10_000, query_batch=16)
    gt = (jgt.precompute(base, queries, k=100),
          tgt.precompute(base, queries, k=100, backend="torch",
                         device="cpu"))
    yield (js, ts), base, queries, gt
    js.shutdown()
    ts.shutdown()


def _set_runtime(systems, **runtime):
    """Repoint each system (facade, index, query service) at its config
    with ``runtime`` changed."""
    for s in systems:
        c2 = dataclasses.replace(s.cfg, runtime=dataclasses.replace(
            s.cfg.runtime, **runtime)).validate()
        for obj in (s, s.index, s.query_service):
            obj.cfg = c2


def _run(pair, clear=True, **runtime):
    """Both systems at ``runtime``: the port's aggregates after checking
    them, and each query row's (retried, returned), against JAX's."""
    systems, base, queries, gt = pair
    _set_runtime(systems, **runtime)
    out = []
    for s, g in zip(systems, gt):
        if clear:
            s.profiler.clear_rows()
        agg = s.run_queries(queries, g, base)
        out.append((agg, [(r.retried, r.returned)
                          for r in s.profiler.rows[-len(queries) * 3:]]))
    (jagg, jrows), (tagg, trows) = out
    assert_same_aggregates(tagg, jagg)
    assert trows == jrows
    return tagg, trows


def test_saturated_margin_identical_to_off(pair):
    off, _ = _run(pair, adaptive_decrypt_margin=0)
    on, _ = _run(pair, adaptive_decrypt_margin=10_000)
    assert on.recall_at_k == pytest.approx(off.recall_at_k)
    assert on.mean_cand_decrypted == off.mean_cand_decrypted


def test_tight_margin_cuts_decrypts_no_spurious_retry(pair):
    off, _ = _run(pair, adaptive_decrypt_margin=0)
    on, rows = _run(pair, adaptive_decrypt_margin=15)
    assert on.mean_cand_decrypted < off.mean_cand_decrypted
    assert on.recall_at_k[10] >= off.recall_at_k[10] - 0.05
    assert not any(retried for retried, _ in rows)
    ext, rows = _run(pair, adaptive_decrypt_margin=1)
    assert ext.mean_cand_decrypted < on.mean_cand_decrypted
    assert not any(retried for retried, _ in rows)
    assert min(returned for _, returned in rows) >= 10
    _run(pair, adaptive_decrypt_margin=0)


def test_probe_mode_unaffected_by_margin(pair):
    off, _ = _run(pair, routing_mode="probe", probe_override=8,
                  adaptive_decrypt_margin=0)
    on, _ = _run(pair, routing_mode="probe", probe_override=8,
                 adaptive_decrypt_margin=50)
    assert on.recall_at_k == pytest.approx(off.recall_at_k)
    assert on.mean_cand_decrypted == off.mean_cand_decrypted
    _run(pair, routing_mode="scan", probe_override=-1,
         adaptive_decrypt_margin=0)


def test_run_queries_aggregates_only_own_rows(pair):
    full, _ = _run(pair, clear=False, adaptive_decrypt_margin=0)
    tight, _ = _run(pair, clear=False, adaptive_decrypt_margin=1)
    tight_clean, _ = _run(pair, adaptive_decrypt_margin=1)
    assert tight.mean_cand_decrypted == tight_clean.mean_cand_decrypted
    assert tight.mean_cand_decrypted < full.mean_cand_decrypted
    assert tight.num_queries == len(pair[2])
    _run(pair, adaptive_decrypt_margin=0)


def test_config_validation():
    from fspann_tpu import config as jconfig
    from fspann_tpu_torch import config as tconfig

    for c in (jconfig, tconfig):
        with pytest.raises(ValueError):
            c.SystemConfig(runtime=c.RuntimeConfig(
                adaptive_decrypt_margin=-1)).validate()
    got = [c.SystemConfig(runtime=c.RuntimeConfig(
        adaptive_decrypt_margin=50, adaptive_decrypt_anchor=1)).validate()
        for c in (jconfig, tconfig)]
    assert got[1].runtime.adaptive_decrypt_anchor == \
        got[0].runtime.adaptive_decrypt_anchor >= got[1].eval.max_k
    assert np.isfinite(got[1].runtime.adaptive_decrypt_anchor)
