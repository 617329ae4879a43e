"""Device time of the packed bit-product kernel (``ops/packed_dots``) at the
deep scan's shapes, beside its bound, its plain version and the two torch
steps it replaces, and the whole packed stage A over 10M rows with the
kernel and with the plain version in its place, on one CUDA device.

    python3 scripts/torch_packed_dots_bench.py [--rows 10000000] [--out f.json]

Random words (24 groups x 4 words: 3,072-bit codes), random query bits,
L = 2,000, adaptive margin 40, the default chunk of 524,288 rows: the
``deep10m-scan`` cell's stage A.  Times are CUDA events over repeated calls
after a warm-up; the words (201 MB a chunk) exceed the 50 MB L2, so each call
reads them from device memory.  Prints one line a reading and, last, a JSON
object with every reading."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fspann_tpu_torch import _build  # noqa: E402
from fspann_tpu_torch.ops import hamming_scan as hs  # noqa: E402
from fspann_tpu_torch.ops import packed_dots as pd  # noqa: E402

G, W, CB, Q, L, CHUNK = 24, 4, 128, 64, 2000, 1 << 19
INT8_OPS = 1979e12       # H100 SXM dense int8, operations/s
HBM = 3.35e12            # bytes/s


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(q: int, c: int) -> tuple[float, str]:
    """Least time of the products alone: 2QCB int8 operations, or the
    words read and the products written once."""
    ops = 2 * q * c * G * CB / INT8_OPS
    by = (c * G * W * 4 + q * c * 4) / HBM
    return max(ops, by) * 1e3, "ops" if ops >= by else "bytes"


def peak_mib(fn) -> float:
    """Peak device memory above what is held, over one call of ``fn``."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2 ** 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    words = torch.randint(-2 ** 31, 2 ** 31, (args.rows, G, W),
                          dtype=torch.int32, device=dev, generator=gen)
    qbits = torch.randint(0, 2, (Q, G * CB), dtype=torch.int8, device=dev,
                          generator=gen)
    pd.packed_dots(qbits[:1], words[:1], CB)          # builds the kernel
    out = {"card": card, "rows": args.rows, "ptxas": [
        ln.strip() for ln in _build.build_logs.get("libpacked_dots.so",
                                                   "").splitlines()
        if "registers" in ln or "spill" in ln or "smem" in ln
        or "entry function" in ln],
        "build_s": _build.build_seconds.get("libpacked_dots.so")}
    print(card, flush=True)
    for ln in out["ptxas"]:
        print("ptxas:", ln, flush=True)

    chunk = words[:CHUNK]
    kernels = {}
    for q, c, name in ((Q, CHUNK, "chunk"), (Q, args.rows - 19 * CHUNK
                                             if args.rows > 19 * CHUNK
                                             else 38_528, "tail"),
                       (7, CHUNK, "chunk q7"), (1, CHUNK, "chunk q1")):
        w = words[:c]
        ms = time_ms(lambda: pd.packed_dots(qbits[:q], w, CB), 20)
        bms, by = bound_ms(q, c)
        kernels[name] = {"q": q, "rows": c, "ms": ms, "bound_ms": bms,
                         "bound_by": by, "share": bms / ms}
        print(f"kernel {name} [{q}, {c}]: {ms:.4f} ms, bound {bms:.4f} ms "
              f"({by}), {100 * bms / ms:.1f}%", flush=True)
    out["kernel"] = kernels
    qb = qbits
    plain_ms = time_ms(lambda: pd.packed_dots_plain(qb, chunk, CB), 5)
    unpack_ms = time_ms(lambda: hs.unpack_bits_device(chunk, CB), 5)
    bits = hs.unpack_bits_device(chunk, CB)
    mm_ms = time_ms(lambda: hs._bit_dots(qb, bits), 5)
    del bits
    out["chunk_plain_ms"] = plain_ms
    out["chunk_unpack_ms"] = unpack_ms
    out["chunk_int_mm_ms"] = mm_ms
    out["chunk_kernel_peak_mib"] = peak_mib(
        lambda: pd.packed_dots(qb, chunk, CB))
    out["chunk_plain_peak_mib"] = peak_mib(
        lambda: pd.packed_dots_plain(qb, chunk, CB))
    print(f"chunk [64, {CHUNK}]: plain {plain_ms:.4f} ms (unpack "
          f"{unpack_ms:.4f} + _int_mm {mm_ms:.4f}); peak above held: kernel "
          f"{out['chunk_kernel_peak_mib']:.1f} MiB, plain "
          f"{out['chunk_plain_peak_mib']:.1f} MiB", flush=True)

    # the whole packed stage A of one batch, the kernel against the plain
    # version in its place, in turns
    n = args.rows
    state = hs.PackedScanState(words, hs._popcounts(words, 1 << 16))
    tomb = torch.zeros(n, dtype=torch.bool, device=dev)
    kw = dict(code_bits=CB, anchor=100, margin=40)

    def stage_a():
        return hs.scan_chunked(state, qb, tomb, L, **kw)

    kernel_res = stage_a()
    real = hs.packed_dots
    turns = {"kernel": [], "plain": []}
    try:
        for side in ("kernel", "plain", "plain", "kernel"):
            hs.packed_dots = real if side == "kernel" else \
                pd.packed_dots_plain
            turns[side].append(time_ms(stage_a, 3))
        hs.packed_dots = pd.packed_dots_plain
        plain_res = stage_a()
        plain_peak = peak_mib(stage_a)
    finally:
        hs.packed_dots = real
    kernel_peak = peak_mib(stage_a)
    same = all(torch.equal(getattr(kernel_res, f), getattr(plain_res, f))
               for f in ("ids", "scores", "n_unique", "n_raw", "n_dec"))
    bms, by = bound_ms(Q, n)
    out["stage_a"] = {"rows": n, "turns_ms": turns, "bound_ms": bms,
                      "bound_by": by, "kernel_peak_mib": kernel_peak,
                      "plain_peak_mib": plain_peak, "equal": same}
    print(f"stage A over {n} rows, Q {Q}, L {L}: kernel {turns['kernel']} ms"
          f", plain {turns['plain']} ms; products' bound {bms:.4f} ms "
          f"({by}); peak above held kernel {kernel_peak:.1f} MiB, plain "
          f"{plain_peak:.1f} MiB; results equal: {same}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
