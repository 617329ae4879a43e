"""Time the set-up's host work on one host thread against the pool of host
threads (``coding.encode_numpy``'s chunks; ``partition.build_partitions_numpy``'s
groups).

    python3 scripts/torch_build_bench.py [--rows N] [--table-rows N] [--out FILE]

At the deep point's shape (d 96, 8 tables x 3 divisions x m 64, λ 2:
3,072-bit codes, 100,000-row ingest batches), times on the host clock:

* the encode of ``--rows`` seeded rows in ingest batches: once on one
  thread; then, three times each in turns, on the pool as the set-up runs
  it (``coding.POOL_ROWS`` rows a thread at a time, numpy's BLAS on one
  thread) with ``POOL_ROWS`` set to 512, 1,024 and 2,048;
* the 24 groups' tables over ``--table-rows`` seeded point-major keys and
  codes, twice each in turns, on the pool: from group-major copies
  (``np.ascontiguousarray`` of the transposes, the copies timed) and from
  the strided views the index's finalize passes.

Every result is checked bit-equal to the first of its kind.  Prints the
host's CPU model and usable cores first, and the card's name and power
limit where ``nvidia-smi`` answers.  ``--out`` writes the readings as JSON.
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

from fspann_tpu_torch.ops import coding, partition  # noqa: E402
from fspann_tpu_torch.store import parallel_read  # noqa: E402

D, M, LAM, TABLES, DIVISIONS = 96, 64, 2, 8, 3
BATCH = 100_000
TABLE_ROWS = 1_000_000
TURNS = 3


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
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        card = "no nvidia-smi"
    return (f"{model}; {len(os.sched_getaffinity(0))} usable cores; pool "
            f"width {parallel_read.default_width()}; {card}")


def _encode(x, bank, width):
    """``x`` in ingest batches on ``width`` host threads."""
    parts = [coding.encode_numpy(x[s:s + BATCH], bank, width=width)
             for s in range(0, len(x), BATCH)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def _timed(runs, turns, check):
    """{name: [seconds]} of ``runs`` ((name, fn) pairs) in turns, each
    result checked by ``check(name, result)``."""
    out = {name: [] for name, _ in runs}
    for _ in range(turns):
        for name, fn in runs:
            t0 = time.perf_counter()
            got = fn()
            out[name].append(time.perf_counter() - t0)
            check(name, got)
    return out


def _report(what, readings):
    for name, ts in readings.items():
        print(f"{what}, {name}: median {np.median(ts):.3f} s "
              f"({', '.join(f'{t:.3f}' for t in ts)})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--table-rows", type=int, default=10_000_000)
    ap.add_argument("--out")
    args = ap.parse_args()
    width = parallel_read.default_width()
    print(host_line(), flush=True)
    rng = np.random.default_rng(96)
    x = rng.normal(size=(args.rows, D)).astype(np.float32)
    bank = coding.build_bank_from_sample(x[:BATCH], M, LAM, TABLES,
                                         DIVISIONS, 13)
    print(f"numpy's BLAS threads found: "
          f"{coding._numpy_blas_threads() is not None}", flush=True)

    t0 = time.perf_counter()
    ref = _encode(x, bank, 1)
    encode = {"one_thread": [time.perf_counter() - t0]}

    def pool(rows):
        def run():
            kept, coding.POOL_ROWS = coding.POOL_ROWS, rows
            try:
                return _encode(x, bank, width)
            finally:
                coding.POOL_ROWS = kept
        return run

    def same_codes(name, got):
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)), name

    encode.update(_timed([(f"pool_{rows}_rows", pool(rows))
                          for rows in (512, 1024, 2048)], TURNS, same_codes))
    _report(f"encode {args.rows} rows", encode)
    del x

    n = args.table_rows
    keys = rng.integers(0, 2 ** 62, size=(n, TABLES * DIVISIONS),
                        dtype=np.int64)
    codes = rng.integers(0, 2 ** 32, size=(n, TABLES * DIVISIONS, 4),
                         dtype=np.uint64).astype(np.uint32)

    def copies():
        return partition.build_partitions_numpy(
            np.ascontiguousarray(keys.T),
            np.ascontiguousarray(np.transpose(codes, (1, 0, 2))), 128,
            width=width)

    def views():
        return partition.build_partitions_numpy(
            keys.T, np.transpose(codes, (1, 0, 2)), 128, width=width)

    first = {}

    def same_table(name, got):
        want = first.setdefault("table", got)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)
                   if a is not None), name

    tables = _timed([("copies_pool", copies), ("views_pool", views)], 2,
                    same_table)
    _report(f"tables of 24 x {n} keys", tables)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"host": host_line(), "rows": args.rows,
                       "table_rows": n, "encode_s": encode,
                       "tables_s": tables}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
