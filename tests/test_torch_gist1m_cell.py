"""The benchmark's ``gist1m-scan.b64`` cell on the CPU at a small size, and
the store's ``store.open.bytes`` counter.

The cell keeps its whole 960-d shape (m 128, so 6,144-bit codes, L 4,000,
margin 72) over 8,192 seeded rows: a sound run reads correct against the
plain ``l2_exact`` reference, and the control (the program's int8 storage,
the precision below the configuration's f16) reads not correct by
``dist_err``.  The counter adds each record that reached an AES-GCM open,
at its ciphertext length, in both of the store's read modes
(``load_score_batch``, ``load_decrypt_batch``)."""

import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_torch import harness  # noqa: E402
from fspann_tpu_torch.crypto.keys import KeyManager  # noqa: E402
from fspann_tpu_torch.store import parallel_read  # noqa: E402
from fspann_tpu_torch.store.point_store import PointStore  # noqa: E402
from fspann_tpu_torch.utils import profiler  # noqa: E402

CELL = "gist1m-scan.b64"
SMALL = {"n": 8192}
# one batch of 64 a cycle, one cycle in the window: the decrypt of ~4,000
# 1,936-byte records a query on one core sets the time
MIX = {"calls": 1}
COUNTER = "store.open.bytes"


def _run(control=False):
    t = time.perf_counter()
    return harness.run_cell(ROOT, CELL, 2 ** 31 + 41, 0.01, False, "cpu", t,
                            t, control=control, overrides=SMALL,
                            traffic_overrides=MIX)


def test_the_cell_keeps_the_wide_shape():
    cell = harness.Cell.find(ROOT, CELL)
    corpus, program = cell.config["corpus"], cell.config["program"]
    assert (corpus["n"], corpus["d"], corpus["d_eff"]) == (1_000_000, 960,
                                                           240)
    cfg = harness.system_config(program)
    assert cfg.paper.num_groups * cfg.paper.code_bits == 6144
    rt = cfg.runtime
    assert (rt.rerank_limit, rt.adaptive_decrypt_margin) == (4000, 72)
    assert (rt.routing_mode, rt.storage_dtype) == ("scan", "f16")
    assert cell.config["reference"] == "l2_exact"
    assert "recall10_new" not in cell.config["limits"]


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["recall10"]["value"] >= 0.95


def test_control_fails_by_dist_err():
    out = _run(control=True)
    assert not out["correct"]
    c = out["checks"]["dist_err"]
    assert c["value"] > float(c["limit"].split()[-1])


def _store(path, dim, rng, n=300):
    """A f16 store of ``n`` rows at ``dim`` with rows 0-9 tombstoned and the
    tag of row 20 corrupted.  Returns (store, live ids)."""
    km = KeyManager(os.path.join(path, "keys.blob"))
    store = PointStore(os.path.join(path, "store"), km, dim, dtype="f16")
    store.insert_batch(np.arange(n),
                       rng.normal(size=(n, dim)).astype(np.float32))
    store.delete(np.arange(10))
    off = int(store.meta._off[20]) + 32 + store._body
    with open(store._arena_path(km.current_version), "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0x5A]))
    return store, np.arange(10, n)


def _opened(read):
    """``read()``, the bytes it counted as opened and the threads that took
    a chunk of it."""
    c = profiler.totals()["counters"]
    before = c.get(COUNTER, 0), c.get("store.open.workers", 0)
    ok = read()
    c = profiler.totals()["counters"]
    return (ok, c.get(COUNTER, 0) - before[0],
            c.get("store.open.workers", 0) - before[1])


# seconds for which a pooled case reads again until more than one thread
# has taken a chunk of one read: whether a woken worker comes before the
# caller has taken every chunk is up to the host's scheduler (on a host of
# virtual cores, the first read to share its chunks came after 1 to 540
# reads of 512 candidates)
POOL_WAIT_S = 30


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("dim,record", [(960, 1936), (128, 272)])
def test_open_bytes_count_the_records_opened(tmp_path, monkeypatch, dim,
                                             record, width):
    """The counter sums the records that reached an open, their tags good
    or not, over every thread that took a chunk.  The reads here are below
    :data:`~.parallel_read.INLINE_BELOW`, so at width 4 the threshold is
    lowered to 0 for them to reach the pool."""
    monkeypatch.setenv("FSPANN_THREADS", str(width))
    if width > 1:
        monkeypatch.setattr(parallel_read, "INLINE_BELOW", 0)
    pooled = parallel_read.default_width() > 1
    rng = np.random.default_rng(dim + width)
    store, live = _store(str(tmp_path), dim, rng)
    assert store.record_ct_len == record
    try:
        # live ids (row 20's bad tag among them) twice over, then ids that
        # reach no open: tombstoned, negative, never written, past capacity
        missing = np.array([0, 3, 9, -1, -5, 300, 4_000, 2 ** 40])
        ids = rng.permutation(np.concatenate([live, live, missing]))
        opened = 2 * len(live)
        q = rng.normal(size=(1, dim)).astype(np.float32)

        def score():
            norms = np.zeros(len(ids), np.float32)
            dots = np.zeros(len(ids), np.float32)
            return store.load_score_batch(ids, q, len(ids), norms, dots)

        def decrypt():
            return store.load_decrypt_batch(ids)[1]

        for read in (score, decrypt):
            most, deadline = 0, time.monotonic() + POOL_WAIT_S
            while True:
                ok, got, workers = _opened(read)
                assert int(ok.sum()) == opened - 2  # row 20's tag fails twice
                assert got == opened * record
                most = max(most, workers)
                if not pooled or most > 1 or time.monotonic() > deadline:
                    break
            assert most > 1 if pooled else most == 1
        _, got, _ = _opened(lambda: store.load_decrypt_batch(missing))
        assert got == 0
    finally:
        store.close()
