"""Time the store's candidate read on the host, ``PointStore.load_*`` (one
native pass on a pool of host threads: ``fspann_tpu_torch/store/
parallel_read.py``, ``csrc/native/open_pool.c``), at each ``FSPANN_THREADS``
width.

    python3 scripts/torch_open_pool_bench.py [--rows N] [--out FILE]

Builds a store of ``--rows`` rows of 128 f16 values (SIFT1M's width and the
benchmark's storage dtype: 304-byte records) under ``$TMPDIR``, holds the
reads at every width to the one-thread read bit for bit on one batch with
misses, then times on the host clock (median of repeats):

* a scan batch's fused score read (64 queries x 1,600 candidates) at
  widths 1, 2, 4, ... up to the usable cores;
* the same at width 1 and at full width with the candidate ids in three
  orders: as drawn, sorted inside each chunk of 1,024, and sorted whole
  (arena order on a dense build);
* a probe batch's staging read (64 x 2,000 rows into a reused buffer) at
  width 1 and at full width;
* small reads (32 to 4,096 candidates), with a 1 ms pause before each so
  that the workers sleep as they do between a serving thread's batches:
  as served (full width, on the caller's thread alone below
  ``INLINE_BELOW``), on one thread, and on the pool at full width with
  ``INLINE_BELOW`` set to 0 for the run.  The last two are what the
  threshold is tuned from: where the pool starts to beat one thread.

Prints the host's CPU model and usable cores first, and the card's name and
power limit where ``nvidia-smi`` answers.  ``--out`` writes the readings as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fspann_tpu_torch.crypto.keys import KeyManager  # noqa: E402
from fspann_tpu_torch.store import parallel_read  # noqa: E402
from fspann_tpu_torch.store.point_store import PointStore  # noqa: E402

DIM = 128
SMALL = (32, 64, 128, 192, 256, 384, 512, 768, 1024, 1600, 2048, 4096)


def host_line() -> str:
    model = "unknown CPU"
    with open("/proc/cpuinfo") as f:
        for ln in f:
            if ln.startswith("model name"):
                model = ln.split(":", 1)[1].strip()
                break
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "no nvidia-smi"
    return (f"{model}; {len(os.sched_getaffinity(0))} usable cpus; "
            f"card {card or 'none'}")


def median_ms(fn, reps: int, pause: float = 0.0) -> float:
    fn()
    ts = []
    for _ in range(reps):
        if pause:
            time.sleep(pause)
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = {"host": host_line()}
    print(out["host"], flush=True)

    rng = np.random.default_rng(20261018)
    work = tempfile.TemporaryDirectory(prefix="open_pool_bench_")
    store = PointStore(os.path.join(work.name, "store"),
                       KeyManager(os.path.join(work.name, "keys.blob")),
                       DIM, dtype="f16")
    t0 = time.perf_counter()
    step = 65_536
    for s in range(0, args.rows, step):
        e = min(s + step, args.rows)
        store.insert_batch(np.arange(s, e), rng.normal(
            size=(e - s, DIM)).astype(np.float32))
    out["build_s"] = time.perf_counter() - t0
    print(f"store of {args.rows} rows in {out['build_s']:.1f} s", flush=True)

    os.environ.pop("FSPANN_THREADS", None)
    full = parallel_read.default_width()
    q = rng.normal(size=(64, DIM)).astype(np.float32)

    def at(width, fn):
        os.environ["FSPANN_THREADS"] = str(width)
        try:
            return fn()
        finally:
            del os.environ["FSPANN_THREADS"]

    def score(ids):
        n = len(ids)
        norms, dots = np.zeros(n, np.float32), np.zeros(n, np.float32)
        rpq = max(1, -(-n // 64))
        return store.load_score_batch(ids, q, rpq, norms, dots), norms, dots

    widths = sorted({1, 2, 4, 8, full} & set(range(1, full + 1)))
    # equality on a batch with misses: absent, negative, past the end
    ids = rng.integers(-50, args.rows + 50, size=64 * 1_600)
    one = at(1, lambda: score(ids))
    stage = np.zeros((len(ids), DIM), np.float32)
    one_v = at(1, lambda: store.load_decrypt_batch(ids, out=stage))[0].copy()
    same = True
    for w in widths[1:]:
        got = at(w, lambda: score(ids))
        same = same and all(np.array_equal(x.view(np.uint8), y.view(np.uint8))
                            for x, y in zip(one, got))
        got_v = at(w, lambda: store.load_decrypt_batch(ids, out=stage))[0]
        same = same and np.array_equal(one_v.view(np.uint32),
                                       got_v.view(np.uint32))
    out["bit_equal"] = bool(same)
    print(f"reads at widths {widths} equal width 1's bit for bit: {same}",
          flush=True)

    ids = rng.integers(0, args.rows, size=64 * 1_600)
    scan = {f"width_{w}": at(w, lambda: median_ms(lambda: score(ids), 7))
            for w in widths}
    out["scan_batch_ms"] = scan
    print("scan batch (102,400 candidates), ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in scan.items()), flush=True)

    chunked = np.concatenate([np.sort(ids[s:s + 1024])
                              for s in range(0, len(ids), 1024)])
    order = {}
    for w in sorted({1, full}):
        for name, arr in (("drawn", ids), ("chunk_sorted", chunked),
                          ("sorted", np.sort(ids))):
            order[f"{name}_width_{w}"] = at(
                w, lambda: median_ms(lambda: score(arr), 7))
    out["order_ms"] = order
    print("orders, ms: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in order.items()), flush=True)

    pids = rng.integers(0, args.rows, size=64 * 2_000)
    buf = np.zeros((len(pids), DIM), np.float32)
    probe = {f"width_{w}": at(w, lambda: median_ms(
        lambda: store.load_decrypt_batch(pids, out=buf), 7))
        for w in sorted({1, full})}
    out["probe_batch_ms"] = probe
    print("probe staging batch (128,000 rows), ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in probe.items()), flush=True)

    def pooled(fn):
        inline, parallel_read.INLINE_BELOW = parallel_read.INLINE_BELOW, 0
        try:
            return fn()
        finally:
            parallel_read.INLINE_BELOW = inline

    small = {}
    for n in SMALL:
        sub = rng.integers(0, args.rows, size=n)

        def timed():
            return median_ms(lambda: score(sub), 200, pause=1e-3)
        small[n] = {"served": timed(), "width_1": at(1, timed),
                    f"pool_width_{full}": pooled(timed)}
        print(f"{n} candidates, ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in small[n].items()), flush=True)
    out["small_ms"] = small
    out["inline_below"] = parallel_read.INLINE_BELOW
    out["pool_threads"] = parallel_read.pool_threads()
    store.close()
    work.cleanup()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
