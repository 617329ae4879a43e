"""Time the query service's touched-set tracking (span ``query.track``) on
the host: each batch recorded whole, split into its steps, against the
touched map (``fspann_tpu_torch/query/touched.py``).

    python3 scripts/torch_track_bench.py [--batches N] [--out FILE]

For each batch size (104,000 touched ids a batch, as ``sift1m-scan.b64``
touches, and 192,000, as ``gist1m-scan.b64``), draws ``--batches`` batches
of int32 ids over 1M rows, Zipf-clustered as the benchmark's corpus is
(1,000 clusters of 1,000 rows, cluster weights 1 / rank), and times on
the host clock, per batch:

* the whole-batch record, step by step: ``np.concatenate`` of the batch's
  parts, ``np.unique``, and ``ReencryptionTracker.record`` (its int64
  copy), with the tracker retaining every batch as it does over a window
  with no drain;
* the allocation alone: a fresh int64 array of the unique ids' size,
  written once and retained, as ``record``'s copy is, against the same
  written into a reused buffer;
* ``np.unique`` of the same batch with nothing retained;
* the touched map: the first batch (the map allocated and every id
  forwarded), the first batch after a drain (the map cleared, every id
  forwarded), and the batches after it (warm).

Prints the host's CPU model and usable cores first, and the card's name
and power limit where ``nvidia-smi`` answers.  ``--out`` writes the
readings as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fspann_tpu_torch.crypto.rotation import ReencryptionTracker  # noqa: E402
from fspann_tpu_torch.query.touched import TouchedMap  # noqa: E402

ROWS = 1_000_000
CLUSTERS = 1_000
SIZES = (104_000, 192_000)


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


def draw(rng, n_batches: int, size: int) -> list[np.ndarray]:
    """Batches of ``size`` int32 ids, Zipf-clustered over ``ROWS``."""
    per = ROWS // CLUSTERS
    w = 1.0 / np.arange(1, CLUSTERS + 1)
    w /= w.sum()
    out = []
    for _ in range(n_batches):
        c = rng.choice(CLUSTERS, size, p=w)
        out.append((c * per + rng.integers(0, per, size)).astype(np.int32))
    return out


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def summary(ms: list[float]) -> dict:
    a = np.asarray(ms)
    return {"median_ms": float(np.median(a)), "mean_ms": float(a.mean()),
            "p90_ms": float(np.quantile(a, 0.9)), "n": len(a)}


def whole_batch(batches) -> dict:
    """The record before the map, step by step, the tracker retaining."""
    tracker = ReencryptionTracker()
    steps = {"concatenate": [], "unique": [], "record": [], "whole": []}
    for b in batches:
        t0 = time.perf_counter()
        cat = np.concatenate([b])
        t1 = time.perf_counter()
        u = np.unique(cat)
        t2 = time.perf_counter()
        tracker.record(u)
        t3 = time.perf_counter()
        steps["concatenate"].append((t1 - t0) * 1e3)
        steps["unique"].append((t2 - t1) * 1e3)
        steps["record"].append((t3 - t2) * 1e3)
        steps["whole"].append((t3 - t0) * 1e3)
    out = {k: summary(v) for k, v in steps.items()}
    out["retained_mb"] = sum(p.nbytes for p in tracker._parts) / 1e6
    return out


def allocation(batches) -> dict:
    """A retained fresh int64 array a batch against a reused one."""
    n = len(np.unique(batches[0]))
    kept, fresh, reused = [], [], []
    buf = np.empty(n, np.int64)
    for _ in batches:
        def new():
            a = np.empty(n, np.int64)
            a[:] = 1
            kept.append(a)
        fresh.append(timed(new))
        reused.append(timed(lambda: buf.fill(1)))
    return {"fresh_retained": summary(fresh), "reused": summary(reused),
            "ids": n}


def unique_alone(batches) -> dict:
    return summary([timed(lambda: np.unique(b)) for b in batches])


def touched_map(batches) -> dict:
    tracker, touched = ReencryptionTracker(), TouchedMap()
    first = timed(lambda: touched.record([batches[0]], tracker, ROWS))
    warm = [timed(lambda: touched.record([b], tracker, ROWS))
            for b in batches[1:]]
    retained = sum(p.nbytes for p in tracker._parts) / 1e6
    tracker.drain()
    after_drain = timed(lambda: touched.record([batches[0]], tracker, ROWS))
    return {"first_ms": first, "after_drain_ms": after_drain,
            "warm": summary(warm), "retained_mb": retained,
            "map_mb": len(touched._marks) / 1e6}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=400)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = {"host": host_line(), "rows": ROWS, "batches": args.batches}
    print(out["host"], flush=True)
    rng = np.random.default_rng(20261018)
    for size in SIZES:
        batches = draw(rng, args.batches, size)
        r = {"whole_batch": whole_batch(batches),
             "allocation": allocation(batches),
             "unique_alone": unique_alone(batches),
             "touched_map": touched_map(batches)}
        out[str(size)] = r
        wb, tm = r["whole_batch"], r["touched_map"]
        print(f"{size} ids a batch: whole-batch record "
              f"{wb['whole']['median_ms']:.3f} ms (concatenate "
              f"{wb['concatenate']['median_ms']:.3f}, unique "
              f"{wb['unique']['median_ms']:.3f}, record "
              f"{wb['record']['median_ms']:.3f}; retained "
              f"{wb['retained_mb']:.1f} MB); unique alone "
              f"{r['unique_alone']['median_ms']:.3f}; a fresh retained "
              f"int64 array {r['allocation']['fresh_retained']['median_ms']:.3f}"
              f" against a reused one "
              f"{r['allocation']['reused']['median_ms']:.3f}; the map: first "
              f"{tm['first_ms']:.3f}, after a drain "
              f"{tm['after_drain_ms']:.3f}, warm "
              f"{tm['warm']['median_ms']:.3f} (retained "
              f"{tm['retained_mb']:.1f} MB, map {tm['map_mb']:.1f} MB)",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
