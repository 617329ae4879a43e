"""Where the packed scan's scratch goes: peak device memory and device time
of each stage of ``hamming_scan.scan_chunked`` over a packed state, on one
CUDA device.

    python3 scripts/torch_packed_scan_memory.py [--rows 1065536] [--out f.json]

Random 3,072-bit codes (24 groups x 4 words), 64 queries, L = 2,000, the
default chunk of 524,288 rows: the shapes of ``chip_smoke.py`` phase 10,
with the exact top-L (``approx=False``).
Each stage runs alone after ``reset_peak_memory_stats``; "scratch" is the
peak above what was allocated before the stage.  Prints one line per stage
and, last, a JSON object with every reading."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fspann_tpu_torch.ops import hamming_scan as hs  # noqa: E402

G, W, CB, Q, L, CHUNK = 24, 4, 128, 64, 2000, 1 << 19


def staged(fn, reps: int = 3) -> tuple[float, float]:
    """(scratch MiB, ms per call) of ``fn``."""
    fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return ((torch.cuda.max_memory_allocated() - held) / 2 ** 20,
            start.elapsed_time(end) / reps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_065_536)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 1 << 32, (args.rows, G, W), dtype=np.uint64) \
        .astype(np.uint32)
    state = hs.build_scan_state_packed(codes, CB, device="cuda")
    qbits = torch.from_numpy(hs.unpack_bits_numpy(codes[:Q], CB)).cuda()
    tomb = torch.zeros(args.rows, dtype=torch.bool, device="cuda")
    words_c, popc_c = state.words[:CHUNK], state.popc[:CHUNK]
    bits_c = hs.unpack_bits_device(words_c, CB)
    part = hs._bit_dots(qbits, bits_c).mul_(-2).add_(popc_c)
    carry = (torch.full((Q, L), hs._DEAD, dtype=torch.int32, device="cuda"),
             torch.full((Q, L), -1, dtype=torch.int32, device="cuda"))
    stages = {
        "word bytes of a chunk": lambda: hs._word_bytes(words_c),
        "unpack a chunk": lambda: hs.unpack_bits_device(words_c, CB),
        "bit product of a chunk": lambda: hs._bit_dots(qbits, bits_c),
        "rank top-L of a chunk": lambda: hs._rank_topk(part, L),
        "chunk step (product, mask, top-L, merge)":
            lambda: hs.scan_chunk_merge(qbits, bits_c, popc_c, tomb[:CHUNK],
                                        0, 0, carry, False),
    }
    out = {"card": card, "rows": args.rows, "chunk": CHUNK,
           "resident_mib": (state.words.numel() * 4
                            + state.popc.numel() * 4) / 2 ** 20,
           "chunk_word_mib": words_c.numel() * 4 / 2 ** 20, "stages": {}}
    print(f"{card}; {args.rows} rows x {G * CB} bits packed, "
          f"{out['resident_mib']:.1f} MiB resident; a chunk of {CHUNK} rows "
          f"is {out['chunk_word_mib']:.1f} MiB of words", flush=True)
    for name, fn in stages.items():
        mib, ms = staged(fn)
        out["stages"][name] = {"scratch_mib": mib, "ms": ms}
        print(f"  {name}: scratch {mib:.1f} MiB, {ms:.3f} ms", flush=True)
    del bits_c, part
    torch.cuda.empty_cache()
    mib, ms = staged(lambda: hs.scan_chunked(state, qbits, tomb, L,
                                             approx=False, anchor=100,
                                             margin=40, code_bits=CB))
    out["stages"]["scan_chunked"] = {"scratch_mib": mib, "ms": ms}
    print(f"  scan_chunked over the whole state: scratch {mib:.1f} MiB, "
          f"{ms:.3f} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
