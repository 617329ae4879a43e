"""Time the port's candidate-Hamming kernel path by path on one CUDA card.

    python3 scripts/torch_code_hamming_bench.py [--rows N] [--out FILE]
                                                 [--skip-192]

Builds ``fspann_tpu_torch/csrc/code_hamming.cu`` twice: as shipped, and with
``-DFSPANN_CODE_HAMMING_COLUMN_FASTEST`` (the gather path with one query's
columns as the fastest block index: the control of the block order).  Then
it builds the probe slice of chip_smoke.py (the LSH-hard corpus, 16 probes,
block 128, device encode) at ``--rows`` rows, takes the ids that the first
batch of 64 queries hands to ``code_hamming``, and on them

* holds every path and geometry against the plain torch twin, bit for bit;
* times one contiguous read of the whole code array (``sum``, ``clone``):
  the practical ceiling of a sweep;
* times, in turns (forward, then backward), the control, the gather path
  and the sweep path at each window size and block size given by
  ``SWEEP_GRID``;
* times the control, the gather and the sweep path on the first 1, 8, 16,
  32 and 64 queries' rows of the same ids, each beside its bound (the
  distinct rows read once), and prints which path ``choose_path`` picks
  there;
* does both at 192 words on random ascending ids (``--skip-192`` leaves
  it out);
* holds the sweep on shuffled ids (a false ``ascending``) against the plain
  twin at 20,000 rows.

CUDA events throughout; prints the card's name and power limit first.
``--out`` also writes the readings as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fspann_tpu_torch import _build  # noqa: E402
from fspann_tpu_torch.ops import code_hamming as ch  # noqa: E402

HBM_BYTES = 3.35e12         # H100 SXM, NVIDIA's data sheet
COLUMN_FASTEST = "FSPANN_CODE_HAMMING_COLUMN_FASTEST"
# (log2 of the rows per window, threads per block) of the sweep; the
# wrapper's own choice at 96 words and 64 queries is (7, 1024)
SWEEP_GRID = ((6, 1024), (7, 512), (7, 1024))
INT32_MAX = 2 ** 31 - 1


def variant_library(define: str) -> ctypes.CDLL:
    """The kernel built with ``-D<define>``, bound like the shipped one."""
    src = os.path.join(_build.CSRC_DIR, "code_hamming.cu")
    path = _build._build(
        f"libcode_hamming_{define.lower()}.so", [src],
        lambda out: [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{define}",
                     "-o", out, src])
    return ch._bind(ctypes.CDLL(path))


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: dict) -> dict:
    """Each function timed twice: in the given order, then reversed."""
    names = list(fns)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        turns[name].append(time_ms(fns[name]))
    return turns


def bound_ms(n, c, qcodes, ids):
    """(distinct rows, valid slots, bound ms): each distinct row read once,
    the query codes and ids read, the scores written."""
    valid = ids[(ids >= 0) & (ids < n)]
    distinct = int(torch.unique(valid).numel())
    nbytes = distinct * c * 4 + qcodes.numel() * 4 + 2 * ids.numel() * 4
    return distinct, int(valid.numel()), nbytes / HBM_BYTES * 1e3


def real_ids(rows: int, dev: str):
    """The code array, query codes and ids of the probe slice's first batch,
    as ``route_rerank`` hands them to ``code_hamming``."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.config import SystemConfig
    from fspann_tpu_torch.io import synthetic
    from fspann_tpu_torch.ops import routing

    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg, paper=dataclasses.replace(cfg.paper, tables=8, m=64),
        runtime=dataclasses.replace(
            cfg.runtime, storage_dtype="f16", encode_backend="default",
            refine_backend="device", probe_override=16, block_size=128,
            refinement_limit=56_000, max_global_candidates=56_000,
            rerank_limit=2000, adaptive_decrypt_margin=40,
            routing_mode="probe")).validate()
    base, queries = synthetic.lsh_hard_corpus(rows, 128, 64, seed=42)
    handed = []

    def spy(pc, qcodes, ids, ascending=False):
        handed.append((pc.clone(), qcodes.clone(), ids.clone(), ascending))
        return ch.code_hamming(pc, qcodes, ids, ascending)

    with tempfile.TemporaryDirectory(prefix="fspann_chbench_") as work:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), 128,
                                      query_batch=64)
        sys_.index_stream(base, batch_size=100_000)
        sys_.finalize_for_search()
        qc, qk = sys_.index.encode_queries(queries)
        routing.code_hamming = spy
        try:
            sys_.index.route_batch(qc, qk)
        finally:
            routing.code_hamming = ch.code_hamming
        sys_.shutdown()
    (pc, hq, ids, ascending), = handed
    if not ascending or pc.device.type != torch.device(dev).type:
        raise RuntimeError(f"handed codes on {pc.device}, ascending "
                           f"{ascending}")
    return pc, hq, ids


def random_ids(n, c, q, r, dev):
    """chip_smoke.py phase 6's inputs: random words, ascending random ids
    with every pad kind mixed in."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23 + c)

    def words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    pc, qc = words((n, c)), words((q, c))
    ids = torch.randint(0, n, (q, r), generator=gen, device=dev,
                        dtype=torch.int64).sort(dim=1).values.to(torch.int32)
    pad = torch.rand((q, r), generator=gen, device=dev) < 0.1
    ids = torch.where(pad, torch.full_like(ids, INT32_MAX), ids)
    ids[:, ::97] = -1
    ids[:, 1::97] = n
    return pc, qc, ids


def fmt(turns) -> str:
    return ", ".join(f"{t:.4f}" for t in turns)


def bench_paths(label, pc, qc, ids, control, out: dict) -> None:
    """Every path on one batch: equality with the plain twin, then times."""
    n, c = pc.shape
    want = ch.code_hamming_plain(pc, qc, ids)
    shipped = ch._lib()

    def gather_control():
        ch._LIB = control
        try:
            return ch.code_hamming_gather(pc, qc, ids)
        finally:
            ch._LIB = shipped

    fns = {"gather, column fastest (control)": gather_control,
           "gather": lambda: ch.code_hamming_gather(pc, qc, ids)}
    for shift, threads in SWEEP_GRID:
        if ch.sweep_smem_bytes(c, shift, ids.shape[0]) > ch.SWEEP_SMEM_BYTES:
            continue
        fns[f"sweep, {1 << shift} rows, {threads} threads"] = (
            lambda s=shift, t=threads: ch.code_hamming_sweep(pc, qc, ids, s,
                                                             t))
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{label}: {name} differs from the plain twin "
                               f"at {int((got != want).sum())} slots")
    distinct, valid, bound = bound_ms(n, c, qc, ids)
    print(f"{label}: {ids.shape[0]} q x {ids.shape[1]} ids over {n} rows x "
          f"{c} words; {valid} valid, {distinct} distinct rows, bound "
          f"{bound:.4f} ms; every path equal to the plain twin", flush=True)
    turns = in_turns(fns)
    for name, t in turns.items():
        ms = sum(t) / len(t)
        print(f"  {name}: {ms:.4f} ms (turns {fmt(t)}), at "
              f"{bound / ms:.1%} of the bound", flush=True)
    out[label] = {"bound_ms": bound, "distinct": distinct, "valid": valid,
                  "turns_ms": turns}


def bench_by_q(label, pc, qc, ids, control, out: dict) -> None:
    """The control, the gather and the sweep on the first Q queries' rows of
    one batch, each beside its bound."""
    n, c = pc.shape
    shipped = ch._lib()
    out[label] = {}
    for q in (1, 8, 16, 32, 64):
        sq, sid = qc[:q].contiguous(), ids[:q].contiguous()
        want = ch.code_hamming_plain(pc, sq, sid)

        def gather_control():
            ch._LIB = control
            try:
                return ch.code_hamming_gather(pc, sq, sid)
            finally:
                ch._LIB = shipped

        fns = {"control": gather_control,
               "gather": lambda: ch.code_hamming_gather(pc, sq, sid),
               "sweep": lambda: ch.code_hamming_sweep(pc, sq, sid)}
        for name, fn in fns.items():
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{label} Q={q}: {name} differs from plain")
        distinct, valid, bound = bound_ms(n, c, sq, sid)
        turns = in_turns(fns)
        ms = {k: sum(t) / len(t) for k, t in turns.items()}
        print(f"{label} Q={q}: {valid} valid, {distinct} distinct rows, bound "
              f"{bound:.4f} ms; column-fastest control {ms['control']:.4f} ms "
              f"(turns {fmt(turns['control'])}), gather "
              f"{ms['gather']:.4f} ms (turns {fmt(turns['gather'])}), sweep "
              f"{ms['sweep']:.4f} ms (turns {fmt(turns['sweep'])}); "
              f"choose_path -> "
              f"{ch.choose_path(q, sid.shape[1], n, c, True)}", flush=True)
        out[label][q] = {"bound_ms": bound, "turns_ms": turns}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--out")
    ap.add_argument("--skip-192", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {card}", flush=True)
    out = {"gpu": card}

    _build.build_all()
    control = variant_library(COLUMN_FASTEST)
    for lib in sorted(_build.build_logs):
        for line in _build.build_logs[lib].splitlines():
            if lib == "libcode_hamming.so" and ("registers" in line
                                                or "Compiling" in line):
                print(f"  ptxas {lib}: {line.strip()}", flush=True)

    pc, qc, ids = real_ids(args.rows, dev)
    n, c = pc.shape
    reads = in_turns({"sum": lambda: pc.sum(), "clone": lambda: pc.clone()})
    nbytes = pc.numel() * 4
    for name, t in reads.items():
        ms = sum(t) / len(t)
        moved = nbytes * (2 if name == "clone" else 1)
        print(f"contiguous {name} of the code array ({nbytes} bytes): "
              f"{ms:.4f} ms (turns {fmt(t)}), {moved / ms / 1e9:.3f} TB/s",
              flush=True)
    out["contiguous_ms"] = reads

    bench_paths("first batch's ids", pc, qc, ids, control, out)

    bench_by_q("real ids", pc, qc, ids, control, out)
    del pc, qc, ids
    torch.cuda.empty_cache()

    if not args.skip_192:
        pc, qc, ids = random_ids(args.rows, 192, 64, 49_152, dev)
        bench_paths("192 words, random ascending ids", pc, qc, ids, control,
                    out)
        bench_by_q("192 words", pc, qc, ids, control, out)
        del pc, qc, ids
        torch.cuda.empty_cache()

    # a false promise: shuffled ids through the sweep
    pc, qc, ids = random_ids(20_000, 96, 64, 4096, dev)
    perm = torch.randperm(ids.shape[1], device=dev)
    ids = ids[:, perm].contiguous()
    want = ch.code_hamming_plain(pc, qc, ids)
    got = ch.code_hamming_sweep(pc, qc, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("sweep on shuffled ids differs from plain")
    ms = time_ms(lambda: ch.code_hamming_sweep(pc, qc, ids))
    gms = time_ms(lambda: ch.code_hamming_gather(pc, qc, ids))
    print(f"shuffled ids (20000 rows, 64 q x 4096): sweep equal to plain, "
          f"{ms:.4f} ms; gather {gms:.4f} ms", flush=True)
    out["shuffled_ms"] = {"sweep": ms, "gather": gms}

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
