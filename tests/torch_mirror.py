"""Shared by the port's mirrors of the JAX package's system-level tests.

A mirror runs the JAX test's scenario through both packages on the CPU with
the same seed-made inputs and compares what comes out.  The JAX system runs
first; its store's ``bank.npz`` (no ``alpha``: JAX regenerates it from the
seed) is then placed in the port's store directory, so the port opens the
JAX bank the way it reopens any JAX store, with ``alpha`` drawn from the
seed's threefry stream and the sample statistics ``(omega, r)`` read from
the file.  Both packages then encode the same codes, and results compare:
integers bit for bit, distances within ``DIST_RTOL``."""

import os
import shutil

import numpy as np

from fspann_tpu import config as jconfig
from fspann_tpu.api.system import ForwardSecureANNSystem as JaxSystem
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.system import ForwardSecureANNSystem as TorchSystem

# Distances: both packages score host refines with the same C kernel, and
# the JAX tests compare restored distances at 1e-5 (test_system_e2e.py)
DIST_RTOL = 1e-5


def systems(cfg_fn, root, dim, query_batch=8):
    """An unbuilt (JAX, port) system pair over ``cfg_fn(config_module)``,
    in ``root/jax`` and ``root/torch``; the port on the CPU."""
    js = JaxSystem(cfg_fn(jconfig), str(root / "jax"), dim,
                   query_batch=query_batch)
    return js, (lambda: TorchSystem(cfg_fn(tconfig), str(root / "torch"),
                                    dim, query_batch=query_batch,
                                    device="cpu"))


def share_bank(root) -> None:
    """Copy the JAX store's bank file into the port's store directory."""
    os.makedirs(root / "torch", exist_ok=True)
    shutil.copy(root / "jax" / "bank.npz", root / "torch" / "bank.npz")


def built_pair(cfg_fn, root, dim, base, batch_size, query_batch=8,
               finalize=True):
    """(JAX, port) systems that indexed ``base`` in batches of
    ``batch_size``, the port on the JAX bank."""
    js, make = systems(cfg_fn, root, dim, query_batch)
    js.index_stream(base, batch_size=batch_size)
    if finalize:
        js.finalize_for_search()
    share_bank(root)
    ts = make()
    ts.index_stream(base, batch_size=batch_size)
    if finalize:
        ts.finalize_for_search()
    return js, ts


def results(sys_, queries, k):
    """(ids, distances) of ``queries`` through the query service, one batch
    per ``query_batch``."""
    b = sys_.query_batch
    res = sys_.query_service.search_batches(
        [sys_.tokens.create_batch(queries[s:s + b], k)
         for s in range(0, len(queries), b)])
    return (np.concatenate([r.ids for r in res]),
            np.concatenate([r.distances for r in res]),
            [s for r in res for s in r.stats])


def assert_same_results(got, want, rtol=DIST_RTOL):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=rtol)
    for f in ("cand_decrypted", "cand_refined", "returned", "retried"):
        assert [getattr(s, f) for s in got[2]] == \
            [getattr(s, f) for s in want[2]], f


def assert_same_search(got, want, rtol=DIST_RTOL):
    """Two ``search`` results (lists of QueryResult) agree."""
    assert [r.id for r in got] == [r.id for r in want]
    np.testing.assert_allclose([r.distance for r in got],
                               [r.distance for r in want], rtol=rtol)


def assert_same_aggregates(got, want, rtol=DIST_RTOL):
    assert got.num_queries == want.num_queries
    assert got.recall_at_k == want.recall_at_k
    assert set(got.ratio_at_k) == set(want.ratio_at_k)
    for k in want.ratio_at_k:
        np.testing.assert_allclose(got.ratio_at_k[k], want.ratio_at_k[k],
                                   rtol=rtol)
    assert got.mean_cand_decrypted == want.mean_cand_decrypted
