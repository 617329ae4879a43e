"""The device refine's decrypt staging buffer (``QueryService._staging``):
allocated once at its largest size and reused by every later batch, pinned
where the refine runs on a CUDA device so that the candidate matrix goes to
the card by one asynchronous copy, and never written while a copy out of it
may still run.

The CPU cases run everywhere; the ``cuda`` cases skip without a card:
``python -m pytest --noconftest -m cuda tests/test_torch_refine_staging.py``."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.system import ForwardSecureANNSystem

N, D, QB = 900, 16, 8


def _system(tmp_path, device, routing):
    rt = dict(refinement_limit=400, max_global_candidates=400, block_size=32,
              routing_mode=routing, rerank_limit=100, encode_backend="cpu",
              refine_backend="device", scan_native="off",
              scan_capacity_rows=0)
    cfg = tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=tconfig.RuntimeConfig(**rt),
        eval=tconfig.EvalConfig(k_variants=(1, 10))).validate()
    rng = np.random.default_rng(7)
    base = rng.normal(size=(N, D)).astype(np.float32)
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "db"), D,
                                  query_batch=QB, device=device)
    sys_.index_stream(base, batch_size=300)
    sys_.finalize_for_search()
    return sys_, base[rng.integers(0, N, 3 * QB)] + 0.01


def _search(sys_, queries, k=10):
    toks = [sys_.tokens.create_batch(queries[s:s + QB], k)
            for s in range(0, len(queries), QB)]
    res = sys_.query_service.search_batches(toks)
    return (np.concatenate([r.ids for r in res]),
            np.concatenate([r.distances for r in res]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory and the "
                    "asynchronous copy need one")
    return "cuda"


@pytest.mark.parametrize("routing", ["probe", "scan"])
def test_staging_is_allocated_once_and_reused(tmp_path, routing):
    sys_, queries = _system(tmp_path, "cpu", routing)
    svc = sys_.query_service
    first = _search(sys_, queries)
    stage = svc._stage
    assert stage.numel() > 0 and not stage.is_pinned()
    again = _search(sys_, queries)
    assert svc._stage.data_ptr() == stage.data_ptr()
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_staging_waits_for_the_last_copy_out_of_it(tmp_path):
    sys_, _ = _system(tmp_path, "cpu", "probe")
    svc = sys_.query_service

    class Copy:
        waited = 0

        def synchronize(self):
            Copy.waited += 1

    svc._stage_copied = Copy()
    got = svc._staging(12, torch.device("cpu"))
    assert Copy.waited == 1 and svc._stage_copied is None
    assert got.numel() == 12 and svc._stage.numel() >= 12
    svc._staging(6, torch.device("cpu"))
    assert Copy.waited == 1


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["probe", "scan"])
def test_pinned_staging_equals_a_pageable_one_cuda(tmp_path, card, routing,
                                                   monkeypatch):
    sys_, queries = _system(tmp_path, card, routing)
    svc = sys_.query_service
    pinned = _search(sys_, queries)
    stage = svc._stage
    assert stage.is_pinned()
    again = _search(sys_, queries)
    assert svc._stage.data_ptr() == stage.data_ptr()

    def pageable(n, dev):
        return torch.zeros(n, dtype=torch.float32)

    monkeypatch.setattr(svc, "_staging", pageable)
    plain = _search(sys_, queries)
    for a, b, c in zip(pinned, again, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
