"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and exits non-zero):
  1. a CUDA device must be present; print its name and power limit;
  2. build the kernels from the checkout's sources, all at once (one nvcc
     for sm_90a per CUDA source, gcc for the host AES-GCM and packed
     Hamming scan libraries);
  3. the L2 top-k kernel against its plain torch twin at K=100, 262,144
     base rows x 256 queries, d=128 and d=960 (the 960-d point's width),
     and against float64 (``ops/l2_topk.float64_error`` at most
     ``F32_ERROR_LIMIT``: float32-accurate, which one TF32 pass is not),
     timed in turns with the plain twin and the library call (addmm + topk,
     ``library_topk``) beside its bound and its split-TF32 floor; pass 1's
     resident blocks per SM;
  4. the Hamming scan on CUDA against the same scan on the CPU: 100k rows
     of 3,072-bit codes, 64-query batch, L=2,000, margin 40, approx=False —
     bit-identical;
  5. the encrypted scan-query slice at bench.py's operating point (1M x 128
     LSH-hard corpus, m=64 → 3,072-bit codes, L=2,000, margin 40, f16
     payloads, host encode, batch 64) through ForwardSecureANNSystem, with
     ground truth from the kernel; recall@10 >= 0.98 and ratio@100 <= 1.01;
     the served route selects approximately, as the JAX package's: one
     ``approx_topk`` launch a batch, a mean share >= APPROX_SHARE_GATE of
     the exact top-2,000 (the same scan with approx=False) kept; then the
     kernel against its plain twin, float64 and the library call at the
     ground-truth shape (1M x 128, 1,024 queries);
  6. the candidate-Hamming kernel's two paths (gather and row-window
     sweep) against its plain torch twin, bit for bit: 1M rows x 96 words,
     64 queries x 49,152 candidates with pads, ascending and shuffled, and
     the same at 192 words; each path timed in turns beside the bound of
     the distinct rows read once, and the path the wrapper picks;
  7. the probe route on CUDA against the same route on the CPU at 100k rows
     (G = 24, W = 4, block 128, 1% tombstones, Q in {64, 7, 1}, narrow and
     wide keys): partition build, route and route_rerank equal on every
     field; device encode flips under 1e-4 of the bits of host encode;
  8. the probe slice at bench.py's BENCH_ROUTING=probe point (the same
     corpus, 16 probes, block 128, 56,000 routed, re-rank to 2,000, f16
     payloads, device encode, device refine, batch 64) through
     ForwardSecureANNSystem: table, codes and refine on the card, both
     kernels launched, the first batch's CUDA route equal to the CPU route
     on copies of the same state with the sweep path picked, and
     ``code_hamming`` timed on the ids that batch hands it, at Q = 64 and on
     the first 1 and 8 queries' rows, each path beside its bound (distinct
     rows read once); recall@10 >= 0.65 and ratio@100 <= 1.03.
     ``route_rerank(approx=True)`` over that batch's pool (not reduced at
     this width) equals the exact route.
     ``--profile`` adds a torch.profiler pass over the served queries;
  9. the packed scan state at phase 4's inputs: built on CUDA == built on
     the CPU, the packed chunked scan == the unpacked flat scan on every
     field with approx=False (Q in {64, 7, 1}, chunk 32,768, and 30,000: a
     ragged tail),
     ``update_rows`` into zero padding keeps the words' storage and scans
     like a fresh build, and the native host scan == the CUDA scan; the
     packed scan's device ms per batch and its peak device memory;
 10. the scan lifecycle at 1M through ForwardSecureANNSystem: phase 5's
     store restored into a packed state padded to 1M + 65,536 rows, the
     1,024 queries served with phase 5's gates and a peak device memory
     UNDER the unpacked scan point's (phase 5) serving peak; the served
     route of every batch equal on every field to ``scan_chunked`` with
     approx=True over phase 5's codes unpacked into the same rows, and with
     approx=False equal to phase 5's exact route; the packed route's device
     ms per batch, 4 live inserts of 16,384 rows in place and one past
     capacity, self search, delete, rotation with re-encryption, flush_all,
     a restore into the served layout that reproduces the results and an
     unpacked restore that reproduces the exact route;
 11. the same store served by the native host scan (exact): the first
     batch's route equals the CUDA scan's with approx=False;
 12. the command line (``fspann_tpu_torch.api.cli``) on 100k rows of the
     corpus with ``--gt AUTO`` and the HARD_SCAN profile of
     configs/hard1m.json, then ``--query-only``: exit 0 and recall@10 at or
     above CLI_RECALL_GATE;
 13. the sharded index (``parallel/sharded.ShardedIndex``) at 1M on the
     card, from phase 5's corpus and bank: built at 1, 4 and 8 shards,
     unpacked and packed, merged on the device ("ici") and on the host; the
     exact scan route (approx=False) of the 1,024 queries at L = 2,000
     equals the single-device scan over the same codes in every combination
     (and phase 5's exact route, when device and host encode agree on every
     bit, which is printed);
     ``build_stream`` in 100,000-row chunks == the one-shot build; the
     probe route with the re-rank at 4 shards == the same route on CPU
     copies of the state, with each shard's ``code_hamming`` path;
     the default ``scan_route`` (approx=True) at 4 shards, unpacked ==
     packed, keeps a mean share >= 0.98 of the exact route (one
     ``approx_topk`` launch a shard and batch); 32
     deletes leave every route; 4 ``append_scan_rows`` of 16,384 rows keep
     the storage and are found by self search; ``save_state`` →
     ``restore_state`` reproduces the route; device ms per batch of 64 at
     1, 4 and 8 shards;
 14. the distributed facade (``parallel/serving.DistributedEncrypted
     System``) at 1M: scan mode, 4 shards, f16 payloads, L = 2,000, margin
     40, batch 64; ``build``, the 1,024 queries through ``search_batches``
     with ground truth from the kernel (recall@10 >= 0.98, ratio@100 <=
     1.01), its scan route equal to phase 13's 4-shard route (the default
     and approx=False), ``insert_live``, ``delete``,
     ``rotate_and_migrate``, ``save_index`` and a fresh object's
     ``restore_index`` serving the same results;
 15. the five ``examples/torch_*.py`` as a user runs them (their default
     sizes and device, the card), all at once as subprocesses: each exits 0
     and prints its recall gate line (``mesh lifecycle OK`` for the mesh).
 16. right after phase 5, on its codes, bank and queries: the approximate
     top-L kernel (``csrc/approx_topk.cu``, the TPU's ``ApproxTopK`` at
     recall_target 0.98) against its plain torch twin, bit for bit, in its
     bins and its selection, with 1% tombstones and Q in {64, 7, 1}, over
     the flat scan at 1M (r 3), the chunked scan's full chunk (r 2) and
     its 475,712-row tail, binned as the JAX package's whole 2^19-row tail
     block (r 2, offset 48,576), one shard of 4 (r 1) and the re-rank's
     width (r 0, the exact top-L); timed at [64, 1M] beside the plain twin,
     the library's bin minimum (``amin``), the exact top-L and its bound;
     then ``scan(approx=True)``, ``scan_chunked(approx=True)`` and the
     packed ``scan_chunked(approx=True)`` at chunk 2^19 over the 16 batches:
     each keeps a mean share >= 0.98 of the exact top-2,000, the flat one
     equals phase 5's served route, and the chunked ones equal a plain
     torch statement of the JAX package's loop (whole chunk-row blocks, the
     tail from n - chunk with the rows already scanned dead).
 17. right after phase 14: the sharded index and the facade at phase 13's
     point with the 4 shards spread over min(4, cards) cards, one slot a
     card (2 cards on a host of 3), or over 4 slots on cuda:0 on a host of
     one card: each resident array one tensor a slot on the slot's card;
     every scan route of the 1,024 queries (unpacked, packed x approx off,
     on x merge on the first card, on the host) and the first batch's probe
     route with the re-rank equal to phase 13's one-slot results; one
     dispatch of each step under ``torch.cuda.set_sync_debug_mode("error")``
     up to ``get()``; the facade over the same slots serves phase 14's ids
     and distances; then ``approx_topk``, ``code_hamming`` (both paths) and
     ``l2_topk`` against their plain twins on every distinct card, on this
     path's inputs.  Printed: the cards, peer access between them, device
     ms per batch (CUDA events on every card), peak memory per card.
 18. right after phase 17, with the earlier phases' state released: the
     JAX package's 960-d point (``WIDE``: 1M x 960, m 128 → 6,144-bit
     codes, L 4,000, margin 72, f16, host encode, batch 64) through
     ForwardSecureANNSystem at full scale: its build's stages and seconds,
     its bank's r and omega equal to the JAX package's from the same
     100,000-row sample, the layout ``scan_packed="auto"`` picks
     (unpacked) and ``route_batch``'s flat-or-chunked branch; the 1,024
     queries served with recall@10 >= 0.95 and ratio@100 <= 1.01 (q/s,
     ART, p50/p95, route/decrypt/refine ms, decrypted), one
     ``approx_topk`` launch a batch, a mean share >= APPROX_SHARE_GATE of
     the exact top-4,000 kept, the kernel equal to its plain twin at [64,
     1M], k 4,000 (timed beside the twin, ``amin`` and its bound), the
     first batch's exact route equal to the native host scan's; then
     ``l2_topk`` at the ground truth's shape as in phase 3; peak device
     memory and the host's MemTotal;
 19. the same at 10M x 96 (``DEEP``: m 64, L 2,000, margin 40; r = 6 at
     [64, 10M]; recall@10 >= 0.98), then the store restored into
     ``scan_packed="on"`` at capacity 10M + 65,536: served with the gates
     under the unpacked serving peak, every batch's route equal to
     ``scan_chunked(approx=True)`` over the same codes unpacked into the
     same rows and, with approx=False, to the unpacked exact route; one
     ``insert_live`` of 16,384 rows in place, found by a self search.
Phase 5 also checks the bank against the JAX package's for the same seed
(``JAX_BANK_FINGERPRINT``) and the sample statistics of the bank its build
draws against the JAX package's from the same sample
(``JAX_SAMPLE_BANK_FINGERPRINT``), and serves a second pass with the 24-bit
id transfer off (``FSPANN_PACK24=0``), equal in every id and distance.
Each served path (phases 5, 8, 10, 12, 13, 14, 16, 17, 18 and 19) runs with
the kernels' launch counts set to 0 just before it and read just after.  The
last two lines of standard output are the kernels' JSON record and the
device JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL_RTOL, TOL_ATOL = 2e-4, 1e-4     # tests/test_pallas_topk.py
# H100 SXM peaks at 700 W (NVIDIA's data sheet): float32 on the CUDA cores,
# TF32 on the tensor cores, HBM3 bytes per second
F32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
N_SLICE = 1_000_000
Q_SLICE = 1024
INT32_MAX = 2 ** 31 - 1
# sha1 (first 12 hex digits) of alpha [24, 64, 128] and the unit offsets
# [24, 64] that the JAX package draws for seed 13 (its coding module's
# _alpha_from_seed / _r_unit_from_seed, JAX 0.9.0 on the CPU): the port's
# threefry bank must reproduce them bit for bit
JAX_BANK_FINGERPRINT = "21921a2cc979"
# sha1 (first 12 hex digits) of r and omega [24, 64] of the bank the JAX
# package builds from phase 5's sample (the first 100,000 rows of the seed
# 42 corpus, f16 round trip; its coding module's build_bank_from_sample,
# JAX 0.9.0 on the CPU), whose corpus fingerprint is CORPUS_FINGERPRINT: the
# port's bank from the same sample must equal it bit for bit, whatever BLAS
# the host has
JAX_SAMPLE_BANK_FINGERPRINT = "887f80dc9c0b"
CORPUS_FINGERPRINT = "c8e24fc51ea0"


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, what) -> None:
    """A check that survives ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def fingerprint(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def release_earlier_phases() -> tuple[int, int]:
    """Free what earlier phases left allocated on the card: a system that
    was shut down stays alive through its reference cycles until Python's
    cycle collector runs, and with it its scan state (3 GB at 1M rows).
    Returns the bytes allocated before and after."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return before, torch.cuda.memory_allocated()


def check_topk(base: torch.Tensor, queries: torch.Tensor, ids_k, d_k,
               ids_p, d_p) -> float:
    """Distances agree within the tolerance; ids differ only where the two
    distances tie within it (checked on exact float64 distances of the
    kernel's ids).  Returns the max |d_kernel - d_plain|."""
    d_k, d_p = d_k.cpu().double(), d_p.cpu().double()
    ids_k, ids_p = ids_k.cpu().long(), ids_p.cpu().long()
    require(torch.isfinite(d_k).all(), "non-finite kernel distances")
    require(d_k.shape == d_p.shape and ids_k.shape == ids_p.shape,
            "shape mismatch")
    err = (d_k - d_p).abs()
    bad = err > TOL_ATOL + TOL_RTOL * d_p.abs()
    require(not bad.any(), f"{int(bad.sum())} distances off, max {err.max()}")
    for row in ids_k:
        require(len(set(row.tolist())) == len(row), "duplicate ids")
    diff = ids_k != ids_p
    if diff.any():
        qi, pos = diff.nonzero(as_tuple=True)
        b = base[ids_k[qi, pos].to(base.device)].double()
        exact = (b - queries[qi.to(base.device)].double()).norm(dim=1).cpu()
        tie = (exact - d_p[qi, pos]).abs() <= TOL_ATOL + TOL_RTOL * d_p[qi, pos]
        require(tie.all(), f"{int((~tie).sum())} id mismatches are not ties")
    log(f"  ids differing at tied distances: {int(diff.sum())} of "
        f"{diff.numel()}")
    return float(err.max())


def library_topk(base: torch.Tensor, queries: torch.Tensor, k: int):
    """The yardstick: one PyTorch call of the same function (|b|^2 - 2 q.b
    by cuBLAS in full float32, then top-k).  Timed only; the port never
    calls it."""
    from fspann_tpu_torch.ops.refine import full_fp32_matmul

    with full_fp32_matmul():
        bsq = (base * base).sum(dim=1)
        return torch.topk(torch.addmm(bsq[None, :], queries, base.T,
                                      alpha=-2.0), k, dim=1, largest=False)


def topk_bound_ms(n: int, d: int, nq: int, k: int) -> tuple[float, str]:
    """Least time for the L2 top-k: 2 Q N d FLOP at the float32 peak against
    each input read once and each output written once."""
    ops = 2 * nq * n * d / F32_FLOPS
    mem = (4 * (n * d + nq * d) + 8 * nq * k) / HBM_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def check_and_time_topk(base, queries, k: int, label: str,
                        reps: int = 3) -> dict:
    """The kernel against its plain twin (``check_topk``) and against
    float64 (``float64_error`` at most ``F32_ERROR_LIMIT``, which one TF32
    pass exceeds), then timed in turns with the plain twin and the library
    call: plain, library, kernel, kernel, library, plain."""
    from fspann_tpu_torch.ops.l2_topk import (F32_ERROR_LIMIT, float64_error,
                                              l2_topk)
    from fspann_tpu_torch.ops.refine import bruteforce_topk

    ids_k, d_k = l2_topk(base, queries, k)
    ids_p, d_p = bruteforce_topk(base, queries, k)
    torch.cuda.synchronize()
    err = check_topk(base, queries, ids_k, d_k, ids_p, d_p)
    f64 = float64_error(base, queries, ids_k, d_k)
    f64_plain = float64_error(base, queries, ids_p, d_p)
    require(f64 <= F32_ERROR_LIMIT, f"l2_topk float64_error {f64:.3e} > "
            f"{F32_ERROR_LIMIT:g}: not float32-accurate")
    del ids_k, d_k, ids_p, d_p
    fns = {"plain": lambda: bruteforce_topk(base, queries, k),
           "library": lambda: library_topk(base, queries, k),
           "kernel": lambda: l2_topk(base, queries, k)}
    turns = {name: [] for name in fns}
    for name in ("plain", "library", "kernel", "kernel", "library", "plain"):
        turns[name].append(time_ms(fns[name], reps=reps))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    (n, d), nq = base.shape, queries.shape[0]
    bound, by = topk_bound_ms(n, d, nq, k)
    floor = 3 * 2 * nq * n * d / TF32_FLOPS * 1e3
    log(f"{label} l2_topk {n}x{d}, {nq} q, K={k}: max |err| {err:.3e}; "
        f"float64_error {f64:.3e} (plain {f64_plain:.3e}, limit "
        f"{F32_ERROR_LIMIT:g}); kernel {ms['kernel']:.3f} ms (turns "
        f"{', '.join(f'{t:.3f}' for t in turns['kernel'])}), plain "
        f"{ms['plain']:.3f} ms, library {ms['library']:.3f} ms (addmm + "
        f"topk); bound {bound:.3f} ms ({by}, float32 peak), kernel at "
        f"{bound / ms['kernel']:.1%} of it; split-TF32 floor {floor:.3f} ms, "
        f"kernel at {floor / ms['kernel']:.1%} of it")
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "bound_ms": bound, "bound_by": by,
            "floor_ms": floor, "floor_share": floor / ms["kernel"],
            "float64_error": f64}


def phase_topk(dev) -> None:
    """Phase 3: the L2 top-k kernel at d = 128 and at the 960-d point's
    width, and the resident blocks its launch geometry assumes."""
    from fspann_tpu_torch.ops import l2_topk as l2

    got = l2.blocks_per_sm()
    require(got == l2.RESIDENT, f"l2_topk pass 1: {got} blocks per SM, "
            f"the geometry assumes {l2.RESIDENT}")
    rng = np.random.default_rng(7)
    for d in (128, 960):
        base = torch.from_numpy(rng.standard_normal((262_144, d),
                                                    dtype=np.float32)).to(dev)
        queries = torch.from_numpy(rng.standard_normal(
            (256, d), dtype=np.float32)).to(dev)
        check_and_time_topk(base, queries, 100, "phase 3")
        del base, queries
    log(f"  l2_topk pass 1: {got} resident blocks per SM")
    torch.cuda.empty_cache()


def scan_inputs():
    """Phases 4 and 9: 100k rows of 3,072-bit codes (24 groups x 128 bits),
    64 near (not equal) queries, 1% tombstones."""
    rng = np.random.default_rng(11)
    n, g, w, cb = 100_000, 24, 4, 128
    codes = rng.integers(0, 1 << 32, (n, g, w), dtype=np.uint64) \
        .astype(np.uint32)
    qcodes = codes[rng.integers(0, n, 64)].copy()
    qcodes[:, :, 0] ^= rng.integers(0, 1 << 32, (64, g), dtype=np.uint64) \
        .astype(np.uint32)
    tomb = rng.random(n) < 0.01
    return codes, qcodes, tomb, cb


def phase_scan(dev) -> float:
    from fspann_tpu_torch.ops import hamming_scan as hs

    codes, qcodes, tomb, cb = scan_inputs()
    qbits = torch.from_numpy(hs.unpack_bits_numpy(qcodes, cb))
    states = {d: hs.build_scan_state(codes, cb, device=d)
              for d in ("cpu", dev)}
    require(torch.equal(states["cpu"].bits, states[dev].bits.cpu()), "bits")
    require(torch.equal(states["cpu"].popc, states[dev].popc.cpu()), "popc")
    # the exact top-L: the default selection is approximate on the card and
    # exact on the CPU (phase 16 holds the approximate one to its twin)
    kw = dict(approx=False, anchor=100, margin=40)
    for q in (64, 7, 1):
        for fn, extra in ((hs.scan, {}), (hs.scan_chunked, {"chunk": 32_768})):
            res = {d: fn(states[d], qbits[:q].to(d),
                         torch.from_numpy(tomb).to(d), 2000, **kw, **extra)
                   for d in ("cpu", dev)}
            for field in ("ids", "scores", "n_unique", "n_raw", "n_dec"):
                a, b = getattr(res["cpu"], field), getattr(res[dev], field)
                require(torch.equal(a, b.cpu()), (fn.__name__, q, field))
    st, qb, tb = states[dev], qbits.to(dev), torch.from_numpy(tomb).to(dev)
    ms = time_ms(lambda: hs.scan(st, qb, tb, 2000, **kw))
    log(f"phase 4 scan 100k x 3072 bits, Q in (64, 7, 1), L=2000, margin "
        f"40, approx=False: CUDA == CPU bit for bit (flat and chunked); CUDA "
        f"flat scan at Q=64: {ms:.3f} ms")
    return ms


def reset_launches() -> None:
    from fspann_tpu_torch.ops.approx_topk import partial_reduce
    from fspann_tpu_torch.ops.code_hamming import code_hamming
    from fspann_tpu_torch.ops.l2_topk import l2_topk
    from fspann_tpu_torch.ops.packed_dots import packed_dots

    l2_topk.launches = code_hamming.launches = partial_reduce.launches = 0
    partial_reduce.tail_launches = packed_dots.launches = 0


def read_launches() -> dict:
    from fspann_tpu_torch.ops.approx_topk import partial_reduce
    from fspann_tpu_torch.ops.code_hamming import code_hamming
    from fspann_tpu_torch.ops.l2_topk import l2_topk
    from fspann_tpu_torch.ops.packed_dots import packed_dots

    return {"l2_topk": l2_topk.launches, "code_hamming": code_hamming.launches,
            "approx_topk": partial_reduce.launches,
            "approx_topk_tail": partial_reduce.tail_launches,
            "packed_dots": packed_dots.launches}


def scan_call(idx, queries, approx: bool = True):
    """The scan that ``idx.route_batch`` runs for ``queries`` (the served
    route selects approximately, ``approx=True``), as a closure over inputs
    already on the card: what CUDA events around it time is the device's
    own work for one batch."""
    from fspann_tpu_torch.ops import hamming_scan as hs

    rt, cb = idx.cfg.runtime, idx.cfg.paper.code_bits
    st, tomb = idx._scan_state, idx._tombstones_scan()
    qbits = torch.from_numpy(hs.unpack_bits_numpy(
        idx.encode_queries(queries)[0], cb)).to(idx.device)
    kw = dict(approx=approx, anchor=rt.adaptive_decrypt_anchor,
              margin=rt.adaptive_decrypt_margin,
              floor=rt.adaptive_decrypt_floor)
    limit = min(rt.effective_refinement(), idx._n_rows)
    if isinstance(st, hs.PackedScanState):
        return lambda: hs.scan_chunked(st, qbits, tomb, limit, code_bits=cb,
                                       **kw)
    return lambda: hs.scan(st, qbits, tomb, limit, **kw)


def exact_route(idx, queries):
    """``idx.route_batch(*idx.encode_queries(queries))`` with the exact
    top-L: the same scan over the same state with ``approx=False``."""
    return idx._map_external(scan_call(idx, queries, approx=False)())


def scan_launches(rows: int, limit: int, chunk: int | None = None) -> int:
    """``approx_topk`` launches of one scan batch over ``rows`` rows: one a
    block (the whole state, or each chunk as ``hamming_scan.scan_chunks``
    cuts it) whose selection is reduced (r > 0 in
    ``reduction_output_size``); a block of r == 0 is the exact top-L."""
    from fspann_tpu_torch.ops.approx_topk import reduction_output_size

    if chunk is None or rows <= chunk:
        return int(reduction_output_size(rows, min(limit, rows))[1] > 0)
    k = min(limit, chunk)
    w, r = reduction_output_size(chunk, k)
    full, left = divmod(rows, chunk)
    # the tail bins as the JAX package's whole chunk-row block past W rows
    # (and re-read whole under k rows); between, each of its live rows sits
    # alone in a bin, and the selection is the exact top-L
    return (r > 0) * (full + (left > w or 0 < left < k))


def slice_cfg(m: int = 64, **runtime):
    """bench.py's scan operating point (phases 5, 10 and 11; at another
    ``m``, L and margin phases 18 and 19), with ``runtime`` overrides."""
    from fspann_tpu_torch.config import SystemConfig

    cfg = SystemConfig()
    runtime = {"rerank_limit": 2000, "adaptive_decrypt_margin": 40,
               **runtime}
    return dataclasses.replace(
        cfg, paper=dataclasses.replace(cfg.paper, tables=8, m=m),
        runtime=dataclasses.replace(
            cfg.runtime, storage_dtype="f16", encode_backend="cpu",
            probe_override=16, block_size=128, refinement_limit=56_000,
            max_global_candidates=56_000, routing_mode="scan",
            **runtime)).validate()


def timed_pass(sys_, queries, gtm, base) -> tuple[float, float, object]:
    """One ``run_queries`` pass: q/s, the mean route wait per query (ms)
    and the aggregates."""
    sys_.profiler.clear_rows()
    t0 = time.perf_counter()
    agg = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
    wall = time.perf_counter() - t0
    rows = [r for r in sys_.profiler.rows if r.k == 10]
    return (len(queries) / wall, sum(r.route_ms for r in rows) / len(rows),
            agg)


def serve(sys_, queries, k: int = 100):
    """ids [Q, k] and distances of ``queries`` through the query service:
    the path ``run_queries`` serves through, without the facade's query
    cache (which re-encryption does not invalidate)."""
    b = sys_.query_batch
    res = sys_.query_service.search_batches(
        [sys_.tokens.create_batch(queries[s:s + b], k)
         for s in range(0, len(queries), b)])
    return (np.concatenate([r.ids for r in res]),
            np.concatenate([r.distances for r in res]))


def require_same(a, b, what) -> None:
    require(np.array_equal(a[0], b[0]), f"{what}: ids differ")
    require(np.array_equal(a[1], b[1]), f"{what}: distances differ")


def to_host(route) -> dict:
    return {f: None if getattr(route, f) is None else
            getattr(route, f).cpu().numpy() for f in FIELDS}


def serve_gated(sys_, label: str, queries, gtm, base,
                recall10: float) -> dict:
    """One warm-up batch, then ``queries`` served through ``run_queries``:
    the peak of device memory and the kernel counts read right after the
    pass (the path's own launches, from the caller's reset on), its times
    and accuracy printed, and the gates held (recall@10 at least
    ``recall10``, ratio@100 at most 1.01)."""
    sys_.run_queries(queries[:64], gtm, base, ks=(10,))   # warm-up
    sys_.profiler.clear_rows()
    peak_pre = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agg = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_launches()
    rows = [r for r in sys_.profiler.rows if r.k == 10]
    nq = len(rows)
    route_ms = sum(r.route_ms for r in rows) / nq
    r10, r100, ratio = (agg.recall_at_k[10], agg.recall_at_k[100],
                        agg.ratio_at_k[100])
    log(f"  served {len(queries)} q: q/s {len(queries) / wall:.1f}  ART "
        f"{agg.mean_art_ms:.3f} ms  p50 {agg.p50_art_ms:.3f}  p95 "
        f"{agg.p95_art_ms:.3f}  route {route_ms:.3f} ms  decrypt "
        f"{sum(r.decrypt_ms for r in rows) / nq:.3f} ms  refine "
        f"{sum(r.refine_ms for r in rows) / nq:.3f} ms per query")
    log(f"  recall@10 {r10:.4f}  recall@100 {r100:.4f}  ratio@100 "
        f"{ratio:.4f}  mean decrypted {agg.mean_cand_decrypted:.1f}  peak "
        f"device memory {peak / 2**30:.2f} GiB (serving), "
        f"{peak_pre / 2**30:.2f} GiB before (from the caller's reset to the "
        f"warm-up); kernel launches on this path {counts}")
    require(r10 >= recall10, f"{label}: recall@10 {r10} < {recall10}")
    require(ratio <= 1.01, f"{label}: ratio@100 {ratio} > 1.01")
    return {"agg": agg, "qps": len(queries) / wall, "route_ms": route_ms,
            "peak": peak, "peak_pre": peak_pre, "counts": counts}


def served_share(idx, label: str, queries, per_batch: int) -> dict:
    """The served route (``route_batch``, approximate) of every batch of 64
    with its ``approx_topk`` launches held to ``per_batch`` a batch, the
    same batches' exact routes (``approx=False``, on the host), and the
    share of each query's exact top-L that the served route keeps, held to
    ``APPROX_SHARE_GATE``."""
    batches = [queries[s:s + 64] for s in range(0, len(queries), 64)]
    before = read_launches()["approx_topk"]
    routed = [idx.route_batch(*idx.encode_queries(q)) for q in batches]
    launches = read_launches()["approx_topk"] - before
    require(per_batch > 0 and launches == len(batches) * per_batch,
            f"{label}: {launches} approx_topk launches for {len(batches)} "
            f"served batches")
    exact = [to_host(exact_route(idx, q)) for q in batches]
    served = tuple(np.concatenate([getattr(r, f).cpu().numpy()
                                   for r in routed]) for f in ("ids", "scores"))
    want = tuple(np.concatenate([e[f] for e in exact])
                 for f in ("ids", "scores"))
    require((served[1] >= want[1]).all(), f"{label}: a served score better "
            "than the exact top-L's at its rank")
    share = retained_share(served[0], want[0])
    require(share.mean() >= APPROX_SHARE_GATE, f"{label}: the served route "
            f"kept {share.mean():.4f} of the exact top-L")
    return {"served": served, "route": want, "exact": exact, "share": share,
            "launches": launches}


def phase_slice(dev, base, queries, work) -> tuple[dict, tuple, dict, dict]:
    """Phase 5; leaves its store in ``work/db`` for phases 10 and 11 and
    returns the kernel counts, every query's ids and distances, the L2
    top-k kernel's record at the ground-truth shape, and what phases 10, 13,
    14 and 16 compare with: the serving peak of device memory, the bank, the
    host-encoded codes, and the served (approximate) and exact scan routes
    of every query."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.io import groundtruth
    from fspann_tpu_torch.ops import coding

    pp = slice_cfg().paper
    shape = (pp.tables * pp.divisions, pp.m, 128)
    drawn = fingerprint(coding._alpha_from_seed(pp.seed, *shape),
                        coding._r_unit_from_seed(pp.seed, *shape[:2]))
    log(f"  bank drawn from seed {pp.seed} at {list(shape)}: alpha + unit "
        f"offsets {drawn}, the JAX package's {JAX_BANK_FINGERPRINT}")
    require(drawn == JAX_BANK_FINGERPRINT, "the threefry bank differs from "
            "the JAX package's")
    sys_ = ForwardSecureANNSystem(slice_cfg(), os.path.join(work, "db"),
                                  128, query_batch=64)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                   # counts from here are the path's
    t0 = time.perf_counter()
    sys_.index_stream(base, batch_size=100_000)
    t_insert = time.perf_counter() - t0
    t0 = time.perf_counter()
    sys_.finalize_for_search()
    t_final = time.perf_counter() - t0
    st = sys_.index._scan_state
    bank = sys_.index.bank
    corpus, stats = fingerprint(base, queries), fingerprint(bank.r, bank.omega)
    log(f"  fingerprints: corpus {corpus}, bank "
        f"{fingerprint(bank.alpha, bank.r, bank.omega)} (r and omega "
        f"{stats}, the JAX package's from this sample "
        f"{JAX_SAMPLE_BANK_FINGERPRINT}), popcounts "
        f"{fingerprint(st.popc.cpu().numpy())}")
    require(corpus == CORPUS_FINGERPRINT, f"the corpus differs from the one "
            f"the sample bank's fingerprint was taken on: {corpus}")
    require(stats == JAX_SAMPLE_BANK_FINGERPRINT, "the bank drawn from the "
            "sample differs from the JAX package's")
    sample = f16_round_trip(base[:100_000])      # the first batch, stored
    t0 = time.perf_counter()
    again = coding.build_bank_from_sample(sample, pp.m, pp.lam, pp.tables,
                                          pp.divisions, pp.seed,
                                          pp.omega_divisor)
    t_bank = time.perf_counter() - t0
    t0 = time.perf_counter()
    coding._omega_from_sample(sample, bank.alpha, coding._r_unit_from_seed(
        pp.seed, *shape[:2]), pp.omega_divisor)
    t_stats = time.perf_counter() - t0
    require(fingerprint(again.r, again.omega) == stats, "the bank rebuilt "
            "from the first 100,000 rows differs from the build's")
    log(f"  the bank rebuilt on the host from the build's sample (the first "
        f"100,000 rows): {t_bank:.2f} s, of which the sample statistics "
        f"(float64 screen, then XLA's float32 order for the candidates) "
        f"{t_stats:.2f} s")
    require(st.bits.device.type == torch.device(dev).type, st.bits.device)
    fs = {k: round(v, 2) for k, v in sys_.index.finalize_sec.items()}
    log(f"  build {t_insert + t_final:.1f} s (insert {t_insert:.1f} + "
        f"finalize {t_final:.1f}: {fs}); scan state "
        f"{tuple(st.bits.shape)} int8 on {st.bits.device}, "
        f"{st.bits.numel() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    gtm = groundtruth.precompute(base, queries, k=100, backend="kernel")
    torch.cuda.synchronize()
    t_gt = time.perf_counter() - t0
    log(f"  GT (kernel) {t_gt:.2f} s")
    sv = serve_gated(sys_, "phase 5", queries, gtm, base, 0.98)
    counts = sv["counts"]
    require(counts["l2_topk"] > 0, "ground truth did not run the l2_topk "
            "kernel")
    # the served route selects approximately: one launch a batch of the
    # flat scan at 1M (the warm-up batch and the pass's 16)
    per_batch = scan_launches(N_SLICE, slice_cfg().runtime
                              .effective_refinement())
    require(per_batch == 1 and counts["approx_topk"]
            >= (1 + Q_SLICE // 64) * per_batch,
            f"the served route did not run approx_topk: {counts}")
    log(f"  {sv['agg'].paper_line()}")
    ref = serve(sys_, queries)
    # the ranked ids cross to the host 24-bit packed by default on the card;
    # one more pass with the packing off must serve the same results
    os.environ["FSPANN_PACK24"] = "0"
    try:
        qps_off, route_off, _ = timed_pass(sys_, queries, gtm, base)
        unpacked = serve(sys_, queries)
    finally:
        del os.environ["FSPANN_PACK24"]
    require_same(unpacked, ref, "FSPANN_PACK24=0 vs the packed default")
    log(f"  24-bit id transfer: on (default) {sv['qps']:.1f} q/s, route "
        f"wait {sv['route_ms']:.3f} ms per query; off {qps_off:.1f} q/s, "
        f"route wait {route_off:.3f} ms per query; every id and distance "
        f"equal")
    idx = sys_.index
    sh = served_share(idx, "phase 5", queries, per_batch)
    share = sh["share"]
    b0 = idx.encode_queries(queries[:64])
    call_ms = time_ms(lambda: idx.route_batch(*b0), reps=5)
    route_ms = time_ms(scan_call(idx, queries[:64]), reps=5)
    exact_ms = time_ms(scan_call(idx, queries[:64], approx=False), reps=5)
    log(f"  served route (approximate top-L, as the JAX package serves): "
        f"{per_batch} approx_topk launch a batch, {sh['launches']} for the "
        f"{Q_SLICE // 64} batches; share of the exact top-2,000 kept: mean "
        f"{share.mean():.6f} min {share.min():.6f} (gate: mean >= "
        f"{APPROX_SHARE_GATE})")
    log(f"  unpacked scan of one batch of 64 on inputs on the card: "
        f"{route_ms:.3f} ms served (approximate), {exact_ms:.3f} ms with "
        f"approx=False (CUDA events); route_batch from host codes, host "
        f"work between launches included: {call_ms:.3f} ms")
    extras = {"peak_serve": sv["peak"], "bank": bank,
              "codes": idx._scan_codes, "route_ms": route_ms,
              "route": sh["route"], "exact": sh["exact"],
              "served_route": sh["served"]}
    sys_.shutdown()

    # the kernel against its plain twin and the library call at the
    # slice's ground-truth shape
    rec = check_and_time_topk(torch.from_numpy(base).to(dev),
                              torch.from_numpy(queries).to(dev), 100,
                              "  phase 5", reps=2)
    torch.cuda.empty_cache()
    return counts, ref, rec, extras


APPROX_L = 2000
APPROX_SHARE_GATE = 0.98      # recall_target of lax.approx_max_k


def approx_bound_ms(q: int, c: int, w: int) -> tuple[float, str]:
    """Least time for the partial reduce: the int32 products, the int32
    popcounts and the one-byte dead marks read once and the int64 bins
    written once, against one compare an element at the CUDA cores'
    float32 peak (the table's only rate outside the tensor cores)."""
    mem = (4 * q * c + 5 * c + 8 * q * w) / HBM_BYTES
    ops = q * c / F32_FLOPS
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def time_approx(dots, w: int, r: int, row0: int = 0, off: int = 0,
                **epi) -> dict:
    """``partial_reduce`` over ``dots`` (int32 [Q, C]) in turns with its
    plain twin and the library's bin minimum (``amin`` over the int64 keys
    padded to [Q, 2^r, W] as the twin pads them; the key's making not
    timed): plain, library, kernel, kernel, library, plain.  Returns the
    kernel's record: mean ms, turns, the others' ms and the bound."""
    from fspann_tpu_torch.ops import approx_topk as at

    q, c = dots.shape
    key = at._rank_keys(dots, row0, **epi)
    key = torch.cat([key.new_full((q, off), at.INT64_MAX), key,
                     key.new_full((q, (w << r) - c - off), at.INT64_MAX)],
                    dim=1)
    fns = {"plain": lambda: at.partial_reduce_plain(dots, w, r, row0,
                                                    off=off, **epi),
           "library": lambda: key.view(q, 1 << r, w).amin(dim=1),
           "kernel": lambda: at.partial_reduce(dots, w, r, row0, off=off,
                                               **epi)}
    turns = {name: [] for name in fns}
    for name in ("plain", "library", "kernel", "kernel", "library", "plain"):
        turns[name].append(time_ms(fns[name], reps=5))
    del key
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    bound, by = approx_bound_ms(q, c, w)
    return {"ms": ms["kernel"], "turns": turns["kernel"],
            "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound_ms": bound, "bound_by": by}


def approx_line(rec: dict) -> str:
    return (f"kernel {rec['ms']:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in rec['turns'])}), plain twin "
            f"{rec['plain_ms']:.3f} ms, library (amin over the padded int64 "
            f"key, the key's making not timed) {rec['library_ms']:.4f} ms; "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{HBM_BYTES / 1e12:.2f} TB/s), kernel at "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it")


def retained_share(got_ids: np.ndarray, want_ids: np.ndarray) -> np.ndarray:
    """Per query: the share of the exact route's live ids that the
    approximate route kept."""
    out = np.empty(len(want_ids))
    for i, (g, w) in enumerate(zip(got_ids, want_ids)):
        w = w[w >= 0]
        out[i] = len(np.intersect1d(g, w)) / max(1, len(w))
    return out


def jax_chunk_loop_plain(state, qbits, dead, limit: int, chunk: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``scan_chunked(approx=True)`` in plain torch, the
    selection binned as ``ops/approx_topk`` defines it: whole ``chunk``-row
    blocks, the tail from ``n - chunk`` with the rows already scanned dead,
    each block's bins over its whole width (``partial_reduce_plain``), a
    (score, id) merge.  Returns (ids, scores) as ``scan_chunked`` does."""
    from fspann_tpu_torch.ops import approx_topk as at
    from fspann_tpu_torch.ops import hamming_scan as hs

    n = state.popc.shape[0]
    k = min(limit, chunk, n)
    w, r = at.reduction_output_size(chunk, k)
    q, dev = qbits.shape[0], qbits.device
    sc = torch.full((q, k), at._DEAD, dtype=torch.int32, device=dev)
    ids = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, chunk):
        lo = min(start, n - chunk)
        rows = torch.arange(lo, lo + chunk, device=dev)
        bins = at.partial_reduce_plain(
            hs._bit_dots(qbits, state.bits[lo:lo + chunk]), w, r, lo,
            popc=state.popc[lo:lo + chunk], scale=-2,
            dead=dead[lo:lo + chunk] | (rows < start))
        bsc, bid = at._smallest(bins, k)
        msc = torch.cat([sc, bsc], dim=1)
        mid = torch.cat([ids, torch.where(bsc < at._DEAD, bid, -1)], dim=1)
        sel = torch.topk((msc.to(torch.int64) << 32) + mid, k, dim=1,
                         largest=False, sorted=True).indices
        sc, ids = msc.gather(1, sel), mid.gather(1, sel)
    live = sc < at._DEAD
    qpopc = qbits.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return (torch.where(live, ids, -1),
            torch.where(live, sc + qpopc[:, None], INT32_MAX))


def phase_approx(dev, queries, p5) -> tuple[dict, dict]:
    """Phase 16, right after phase 5 on its codes, bank and queries: the
    approximate top-L (``ops/approx_topk``) kernel against its plain twin,
    bit for bit, at the shapes its callers give it, timed beside the twin,
    the library's bin minimum, the exact top-L and its bound; then
    ``scan(approx=True)`` and ``scan_chunked(approx=True)`` over the 16
    batches of 64, with the share of the exact top-L that they keep.
    Returns the path's kernel counts and the kernel's record."""
    from fspann_tpu_torch.ops import approx_topk as at
    from fspann_tpu_torch.ops import coding
    from fspann_tpu_torch.ops import hamming_scan as hs

    release_earlier_phases()
    bank = p5["bank"]
    cb = bank.code_bits
    state = hs.build_scan_state(p5["codes"], cb, device=dev)
    qbits = torch.from_numpy(hs.unpack_bits_numpy(
        coding.encode_numpy(queries, bank)[0], cb)).to(dev)
    n = state.popc.shape[0]
    tomb = torch.from_numpy(np.random.default_rng(16).random(n) < 0.01) \
        .to(dev)
    # (what, first row, rows, block width): the flat scan at 1M (r 3), the
    # chunked scan's full chunk (r 2) and its tail, binned as the JAX
    # package's whole 2^19-row tail block (r 2, offset 2^19 - rows), one
    # shard of 4 at phase 13's capacity (r 1), and the probe point's
    # re-rank width, where nothing is reduced
    shapes = [("flat scan", 0, n, n), ("full chunk", 0, 1 << 19, 1 << 19),
              ("chunk tail", 1 << 19, n - (1 << 19), 1 << 19),
              ("shard of 4", 0, SHARD_CAP // 4, SHARD_CAP // 4),
              ("no reduction", 0, 56_000, 56_000)]
    checked = []
    err = 0
    for what, lo, c, width in shapes:
        w, r = at.reduction_output_size(width, APPROX_L)
        off = width - c
        for q in (64, 7, 1):
            dots = hs._bit_dots(qbits[:q], state.bits[lo:lo + c])
            epi = dict(popc=state.popc[lo:lo + c], scale=-2,
                       dead=tomb[lo:lo + c])
            sel = at.approx_rank_topk(dots, APPROX_L, lo, width=width, **epi)
            if r == 0:
                part = (dots * -2 + epi["popc"]).masked_fill(
                    epi["dead"][None, :], at._DEAD)
                plain = hs._rank_topk(part, APPROX_L, lo)
            else:
                got = at.partial_reduce(dots, w, r, lo, off=off, **epi)
                want = at.partial_reduce_plain(dots, w, r, lo, off=off, **epi)
                require(torch.equal(got, want), (what, q, "bins"))
                plain = at._smallest(want, APPROX_L)
                if q == 7:       # the re-rank's epilogue: the values as given
                    require(torch.equal(
                        at.partial_reduce(dots, w, r, lo, off=off),
                        at.partial_reduce_plain(dots, w, r, lo, off=off)),
                        (what, q, "bins without epilogue"))
            for a, b in zip(sel, plain):
                require(torch.equal(a, b), (what, q, "selection"))
            err = max(err, int((sel[0] - plain[0]).abs().max()))
        checked.append(f"{what} [Q, {c}] W={w} r={r}"
                       + (f" offset {off}" if off else ""))
    log(f"phase 16 approx_topk (lax.approx_max_k, recall_target 0.98) at "
        f"L={APPROX_L} on phase 5's codes, 1% tombstones, Q in (64, 7, 1): "
        f"kernel == plain twin bit for bit (bins and selection) at "
        f"{'; '.join(checked)}")

    # times at the flat scan's shape, Q = 64, in turns
    dots = hs._bit_dots(qbits[:64], state.bits)
    epi = dict(popc=state.popc, scale=-2, dead=tomb)
    w, r = at.reduction_output_size(n, APPROX_L)
    rec = time_approx(dots, w, r, **epi)
    part = (dots * -2 + state.popc).masked_fill(tomb[None, :], at._DEAD)
    fns = {"exact": lambda: hs._rank_topk(part, APPROX_L),
           "select": lambda: at.approx_rank_topk(dots, APPROX_L, **epi)}
    turns = {name: [] for name in fns}
    for name in ("exact", "select", "select", "exact"):
        turns[name].append(time_ms(fns[name], reps=5))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    del part, dots
    log(f"  [64, {n}] -> W={w} bins (r={r}): " + approx_line(rec)
        + f"; whole approximate selection (kernel + topk of the bins) "
        f"{ms['select']:.4f} ms, exact top-L of the same rank values "
        f"({APPROX_L} of {n}, one int64 key) {ms['exact']:.4f} ms")

    # the chunked scan's tail with its offset, Q = 64, in turns
    lo = 1 << 19
    w_t, r_t = at.reduction_output_size(lo, APPROX_L)
    dots = hs._bit_dots(qbits[:64], state.bits[lo:])
    tail = time_approx(dots, w_t, r_t, lo, 2 * lo - n, popc=state.popc[lo:],
                       scale=-2, dead=tomb[lo:])
    del dots
    log(f"  chunk tail [64, {n - lo}] at offset {2 * lo - n} -> W={w_t} bins "
        f"(r={r_t}), the JAX package's 2^19-row block: " + approx_line(tail))

    # the path: the scan entry points with approx=True over the 16 batches,
    # the chunked scan on the bits and on the packed words
    no_tomb = torch.zeros(n, dtype=torch.bool, device=dev)
    packed = hs.build_scan_state_packed(p5["codes"], cb, device=dev)
    reset_launches()                   # counts from here are the path's
    runs = {"flat": [], "chunked": [], "packed": [], "exact": []}
    for s in range(0, Q_SLICE, 64):
        qb = qbits[s:s + 64]
        runs["flat"].append(hs.scan(state, qb, no_tomb, APPROX_L,
                                    approx=True))
        runs["chunked"].append(hs.scan_chunked(state, qb, no_tomb, APPROX_L,
                                               approx=True))
        runs["packed"].append(hs.scan_chunked(packed, qb, no_tomb, APPROX_L,
                                              approx=True, code_bits=cb))
        runs["exact"].append(hs.scan(state, qb, no_tomb, APPROX_L,
                                     approx=False))
    counts = read_launches()
    got = {k: tuple(np.concatenate([getattr(x, f).cpu().numpy() for x in v])
                    for f in ("ids", "scores")) for k, v in runs.items()}
    require_same(got["exact"], p5["route"], "exact scan vs phase 5's route")
    require_same(got["flat"], p5["served_route"],
                 "scan(approx=True) vs phase 5's served route")
    # one kernel launch a flat batch, two a chunked one (full chunk + tail,
    # the tail's with its offset), bits or words
    require(counts["approx_topk"] == 5 * Q_SLICE // 64
            and counts["approx_topk_tail"] == 2 * Q_SLICE // 64,
            f"approx_topk launches {counts}")
    require_same(got["packed"], got["chunked"], "packed vs unpacked "
                 "scan_chunked(approx=True)")
    jax_loop = [jax_chunk_loop_plain(state, qbits[s:s + 64], no_tomb,
                                     APPROX_L, 1 << 19)
                for s in range(0, Q_SLICE, 64)]
    require_same(tuple(np.concatenate([x[i].cpu().numpy() for x in jax_loop])
                       for i in (0, 1)), got["chunked"],
                 "scan_chunked(approx=True) vs the plain statement of the "
                 "JAX package's chunk loop")
    shares = {}
    for k in ("flat", "chunked"):
        ids, sc = got[k]
        require((sc[:, 1:] >= sc[:, :-1]).all(), f"{k}: scores not sorted")
        require((sc >= got["exact"][1]).all(), f"{k}: a score better than "
                "the exact top-L's at its rank")
        share = retained_share(ids, got["exact"][0])
        shares[k] = share
        require(share.mean() >= APPROX_SHARE_GATE,
                f"{k} scan kept {share.mean():.4f} < {APPROX_SHARE_GATE}")
    qb = qbits[:64]
    scan_ms = {name: time_ms(fn, reps=5) for name, fn in (
        ("approx", lambda: hs.scan(state, qb, no_tomb, APPROX_L,
                                   approx=True)),
        ("exact", lambda: hs.scan(state, qb, no_tomb, APPROX_L,
                                  approx=False)),
        ("chunked approx", lambda: hs.scan_chunked(
            state, qb, no_tomb, APPROX_L, approx=True)),
        ("chunked exact", lambda: hs.scan_chunked(state, qb, no_tomb,
                                                  APPROX_L, approx=False)))}
    log(f"  scan(approx=True) over the {Q_SLICE // 64} batches == phase 5's "
        f"served route, scan(approx=False) == its exact route, "
        f"scan_chunked(approx=True) at chunk 2^19 on the bits == on the "
        f"packed words == the plain statement of the JAX package's loop "
        f"(the {n - (1 << 19)}-row tail binned as its 2^19-row block); "
        f"share of the exact top-{APPROX_L} kept: "
        f"flat mean {shares['flat'].mean():.6f} min "
        f"{shares['flat'].min():.6f}, chunked (2^19 rows) mean "
        f"{shares['chunked'].mean():.6f} min {shares['chunked'].min():.6f} "
        f"(gate: mean >= {APPROX_SHARE_GATE}); kernel launches on this path "
        f"{counts}; one batch of 64 (CUDA events): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in scan_ms.items()))
    del state, packed, qbits, tomb, no_tomb, runs, jax_loop
    torch.cuda.empty_cache()
    del rec["turns"]
    return counts, {"max_abs_err": float(err), **rec,
                    "select_ms": ms["select"], "exact_ms": ms["exact"],
                    "share_mean": float(shares["flat"].mean()),
                    "share_min": float(shares["flat"].min()),
                    "tail_ms": tail["ms"], "tail_plain_ms": tail["plain_ms"],
                    "tail_library_ms": tail["library_ms"],
                    "tail_bound_ms": tail["bound_ms"]}


def hamming_bound(n: int, c: int, qcodes: torch.Tensor,
                  ids: torch.Tensor) -> tuple[int, int, float]:
    """``code_hamming``'s least bytes: each distinct candidate row (pads
    excluded) read once, the query codes and ids read, the scores written.
    Returns (distinct rows, bytes, bound ms at HBM_BYTES)."""
    valid = ids[(ids >= 0) & (ids < n)]
    distinct = int(torch.unique(valid).numel())
    nbytes = distinct * c * 4 + qcodes.numel() * 4 + 2 * ids.numel() * 4
    return distinct, nbytes, nbytes / HBM_BYTES * 1e3


def time_hamming_paths(pc, qc, ids, reps: int = 10) -> dict:
    """Both paths of ``code_hamming`` on one batch, in turns (gather, sweep,
    sweep, gather): the two readings of each."""
    from fspann_tpu_torch.ops import code_hamming as ch

    fns = {"gather": lambda: ch.code_hamming_gather(pc, qc, ids),
           "sweep": lambda: ch.code_hamming_sweep(pc, qc, ids)}
    turns = {name: [] for name in fns}
    for name in ("gather", "sweep", "sweep", "gather"):
        fns[name]()                                         # warm-up
        turns[name].append(time_ms(fns[name], reps=reps))
    return turns


def phase_code_hamming(dev) -> dict:
    """The candidate-Hamming kernel's two paths against its plain twin, bit
    for bit, at the probe slice's shape (Q=64, R = 24 groups x 16 probes x
    128 rows) and at the 6,144-bit width, on ascending and on shuffled
    ids."""
    from fspann_tpu_torch.ops import code_hamming as ch

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    n, q, r = N_SLICE, 64, 49_152
    rec = None

    def words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    for c in (96, 192):
        pc, qc = words((n, c)), words((q, c))
        # id-ascending candidates as the route hands them over, with every
        # pad kind mixed in: INT32_MAX (dedup), -1 and n (out of range)
        ids = torch.randint(0, n, (q, r), generator=gen, device=dev,
                            dtype=torch.int64).sort(dim=1).values \
            .to(torch.int32)
        pad = torch.rand((q, r), generator=gen, device=dev) < 0.1
        ids = torch.where(pad, torch.full_like(ids, INT32_MAX), ids)
        ids[:, ::97] = -1
        ids[:, 1::97] = n
        shuffled = ids[:, torch.randperm(r, generator=gen, device=dev)] \
            .contiguous()
        want = ch.code_hamming_plain(pc, qc, ids)
        err = 0.0
        for name, fn in (("gather", ch.code_hamming_gather),
                         ("sweep", ch.code_hamming_sweep)):
            got = fn(pc, qc, ids)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"code_hamming {name} C={c} != "
                    f"plain on ascending ids")
            err = max(err, float((got.long() - want.long()).abs().max()))
        # the sweep under a false promise: exact, and slow (every span
        # covers most of the row); one launch, timed as it is checked
        want_s = ch.code_hamming_plain(pc, qc, shuffled)
        require(torch.equal(ch.code_hamming_gather(pc, qc, shuffled), want_s),
                f"code_hamming gather C={c} != plain on shuffled ids")
        box = []
        false_ms = time_ms(lambda: box.append(
            ch.code_hamming_sweep(pc, qc, shuffled)), reps=1)
        require(torch.equal(box.pop(), want_s),
                f"code_hamming sweep C={c} != plain on shuffled ids")
        gather_shuffled = time_ms(
            lambda: ch.code_hamming_gather(pc, qc, shuffled), reps=10)
        del want_s, shuffled, got
        p1 = time_ms(lambda: ch.code_hamming_plain(pc, qc, ids))
        turns = time_hamming_paths(pc, qc, ids)
        p2 = time_ms(lambda: ch.code_hamming_plain(pc, qc, ids))
        ms = {name: sum(t) / len(t) for name, t in turns.items()}
        plain_ms = (p1 + p2) / 2
        path = ch.choose_path(q, r, n, c, True)
        distinct, nbytes, bound = hamming_bound(n, c, qc, ids)
        log(f"phase 6 code_hamming {n} rows x {c} words, {q} q x {r} "
            f"candidates: gather and sweep equal to plain bit for bit on "
            f"ascending and on shuffled ids; ascending: gather "
            f"{ms['gather']:.3f} ms (turns "
            f"{', '.join(f'{t:.3f}' for t in turns['gather'])}), sweep "
            f"{ms['sweep']:.3f} ms (turns "
            f"{', '.join(f'{t:.3f}' for t in turns['sweep'])}; "
            f"{ch.window_shift(c, q)} = log2 rows a window), plain "
            f"{plain_ms:.3f} ms (turns {p1:.3f}, {p2:.3f}); bound "
            f"{bound:.3f} ms ({distinct} distinct rows, {nbytes} bytes read "
            f"once); the wrapper picks {path}, at {bound / ms[path]:.1%} of "
            f"the bound; shuffled: gather {gather_shuffled:.3f} ms, sweep "
            f"under the false promise {false_ms:.1f} ms; no PyTorch call "
            f"computes it")
        if rec is None:
            # the path the main route takes; its design's floor is the same
            # bytes bound
            rec = {"max_abs_err": err, "ms": ms[path], "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": bound,
                   "bound_by": "bytes", "floor_ms": bound,
                   "floor_share": bound / ms[path], "path": path,
                   "gather_ms": ms["gather"], "sweep_ms": ms["sweep"]}
        del pc, qc, ids, want
    torch.cuda.empty_cache()
    return rec


def _require_tables_equal(a, b, what) -> None:
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        require((x is None) == (y is None), (what, f))
        if x is not None:
            require(x.dtype == y.dtype and np.array_equal(x, y), (what, f))


def phase_probe_equal(dev, base, queries) -> None:
    """Partition build, probe route and device encode on CUDA against the
    CPU, at 100k rows of the slice's corpus and code geometry."""
    from fspann_tpu_torch.ops import coding, partition, routing

    n, probes, block = min(100_000, len(base)), 16, 128
    x = base[:n]
    bank = coding.build_bank_from_sample(x[:1000], 64, 2, 8, 3, 13)
    codes, keys = coding.encode_numpy(x, bank)
    dcodes, dkeys = coding.encode(torch.from_numpy(x).to(dev),
                                  coding.bank_to(bank, dev))
    flips = int(np.unpackbits(
        (coding.words_to_numpy(dcodes) ^ codes).view(np.uint8)).sum())
    total = n * bank.g * bank.code_bits
    require(flips < 1e-4 * total, f"device encode flipped {flips} bits")
    require(np.array_equal(dkeys.cpu().numpy(), coding.keys_from_codes(
        dcodes).cpu().numpy()), "device keys")
    rng = np.random.default_rng(17)
    tomb = torch.from_numpy(rng.random(n) < 0.01)
    qc, qk = coding.encode_numpy(queries[:64], bank)
    pc_cpu = coding.words_to_torch(codes)
    pc_dev = pc_cpu.to(dev)
    keys_gn = np.ascontiguousarray(keys.T)
    codes_gn = np.ascontiguousarray(codes.transpose(1, 0, 2))
    fields = ("ids", "scores", "n_unique", "n_raw")
    ms = {}
    for wide in (False, True):
        host = partition.build_partitions_numpy(keys_gn, codes_gn, block,
                                                wide=wide)
        dtab = partition.build_partitions(
            torch.from_numpy(keys_gn).to(dev),
            coding.words_to_torch(codes_gn, dev), block, wide=wide)
        _require_tables_equal(partition.table_to_numpy(dtab), host,
                              ("build", wide))
        ctab = partition.table_to(host, "cpu")
        for q in (64, 7, 1):
            a = (coding.words_to_torch(qc[:q]), torch.from_numpy(qk[:q]),
                 tomb)
            ad = tuple(t.to(dev) for t in a)
            for fn, extra, extra_dev in (
                    (routing.route, (probes, 56_000), (probes, 56_000)),
                    (routing.route_rerank, (pc_cpu, probes, 2000),
                     (pc_dev, probes, 2000))):
                want = fn(ctab, *a, *extra)
                got = fn(dtab, *ad, *extra_dev)
                for f in fields:
                    require(torch.equal(getattr(got, f).cpu(),
                                        getattr(want, f)),
                            (fn.__name__, wide, q, f))
        a = tuple(t.to(dev) for t in (coding.words_to_torch(qc),
                                      torch.from_numpy(qk), tomb))
        ms[wide] = time_ms(lambda: routing.route_rerank(
            dtab, *a, pc_dev, probes, 2000))
    log(f"phase 7 probe route {n} rows, G=24, W=4, block 128, 1% "
        f"tombstones, Q in (64, 7, 1): CUDA == CPU on every field (build, "
        f"route, route_rerank; narrow and wide keys); device encode flipped "
        f"{flips} of {total} bits ({flips / total:.2e}); CUDA route_rerank "
        f"at Q=64: {ms[False]:.3f} ms narrow, {ms[True]:.3f} ms wide")
    torch.cuda.empty_cache()


def _profile_pass(sys_, queries, gtm, base) -> None:
    """One served pass under torch.profiler: device busy share and the
    device kernels and copies that take the time.  Only device-side events
    are summed (a CPU op's row repeats its kernels' device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sys_.run_queries(queries, gtm, base, ks=(10,))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in ev) / 1e3
    log(f"  profiled pass: {busy:.2f} ms of device time in a "
        f"{wall * 1e3:.1f} ms pass (device busy {busy / (wall * 1e3):.1%}, "
        f"{sum(e.count for e in ev)} device events)")
    for e in ev[:10]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6} {e.key[:90]}")


def phase_probe_slice(dev, base, queries, profile: bool) -> dict:
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.config import SystemConfig
    from fspann_tpu_torch.io import groundtruth
    from fspann_tpu_torch.ops import coding, partition, routing
    from fspann_tpu_torch.ops import code_hamming as ch_mod
    from fspann_tpu_torch.ops import refine as refine_mod
    from fspann_tpu_torch.ops.approx_topk import reduction_output_size
    from fspann_tpu_torch.ops.code_hamming import code_hamming

    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg, paper=dataclasses.replace(cfg.paper, tables=8, m=64),
        runtime=dataclasses.replace(
            cfg.runtime, storage_dtype="f16", encode_backend="default",
            refine_backend="device", probe_override=16, block_size=128,
            refinement_limit=56_000, max_global_candidates=56_000,
            rerank_limit=2000, adaptive_decrypt_margin=40,
            routing_mode="probe")).validate()
    rt = cfg.runtime
    refine_devices = set()
    plain_refine = refine_mod.refine

    def refine_spy(*args, **kw):
        refine_devices.add(args[1].device.type)
        return plain_refine(*args, **kw)

    work = tempfile.mkdtemp(prefix="fspann_smoke_probe_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), 128,
                                      query_batch=64)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        refine_mod.refine = refine_spy
        reset_launches()                   # counts from here are the path's
        t0 = time.perf_counter()
        sys_.index_stream(base, batch_size=100_000)
        t_insert = time.perf_counter() - t0
        t0 = time.perf_counter()
        sys_.finalize_for_search()
        t_final = time.perf_counter() - t0
        t0 = time.perf_counter()
        gtm = groundtruth.precompute(base, queries, k=100, backend="kernel")
        torch.cuda.synchronize()
        t_gt = time.perf_counter() - t0
        sys_.run_queries(queries[:64], gtm, base, ks=(10,))   # warm-up
        sys_.profiler.clear_rows()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        agg = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
        wall = time.perf_counter() - t0
        counts = read_launches()
        refine_mod.refine = plain_refine
        peak_serve = torch.cuda.max_memory_allocated()
        idx = sys_.index
        bank = idx.bank
        fs = {k: round(v, 2) for k, v in idx.finalize_sec.items()}
        log(f"phase 8 probe slice {N_SLICE}x128, {Q_SLICE} q: fingerprints "
            f"bank {fingerprint(bank.alpha, bank.r, bank.omega)}, table ids "
            f"{fingerprint(idx.table.ids.cpu().numpy())}")
        log(f"  build {t_insert + t_final:.1f} s (insert with device encode "
            f"{t_insert:.1f} + finalize {t_final:.1f}: {fs}); table ids "
            f"{tuple(idx.table.ids.shape)} on {idx.table.ids.device}, point "
            f"codes {tuple(idx.point_codes.shape)} on "
            f"{idx.point_codes.device}")
        require(idx.table.ids.device.type == "cuda", "table not on cuda")
        require(idx.point_codes.device.type == "cuda", "codes not on cuda")
        require(refine_devices == {"cuda"}, f"refine ran on {refine_devices}")
        require(counts["code_hamming"] > 0, "route did not run code_hamming")
        require(counts["l2_topk"] > 0, "ground truth did not run l2_topk")
        rows = [r for r in sys_.profiler.rows if r.k == 10]
        nq = len(rows)
        log(f"  GT (kernel) {t_gt:.2f} s; kernel launches on this path "
            f"{counts}; refine ran on {sorted(refine_devices)}")
        log(f"  {agg.paper_line()}")
        log(f"  q/s {Q_SLICE / wall:.1f}  ART {agg.mean_art_ms:.3f} ms  "
            f"p50 {agg.p50_art_ms:.3f}  p95 {agg.p95_art_ms:.3f}  "
            f"route {sum(r.route_ms for r in rows) / nq:.3f} ms  decrypt "
            f"{sum(r.decrypt_ms for r in rows) / nq:.3f} ms  refine "
            f"{sum(r.refine_ms for r in rows) / nq:.3f} ms per query")
        r10, r100 = agg.recall_at_k[10], agg.recall_at_k[100]
        ratio = agg.ratio_at_k[100]
        log(f"  recall@10 {r10:.4f}  recall@100 {r100:.4f}  ratio@100 "
            f"{ratio:.4f}  mean decrypted {agg.mean_cand_decrypted:.1f}  "
            f"peak device memory {peak / 2**30:.2f} GiB (build, ground "
            f"truth, warm-up), {peak_serve / 2**30:.2f} GiB (serving)")

        # the first batch's route on the card against the plain torch route
        # on CPU copies of the same table, codes and tombstones; the ids it
        # hands to code_hamming give that kernel's bound on real candidates
        qc, qk = idx.encode_queries(queries[:64])
        handed = []

        def hamming_spy(pc, qcodes, ids, ascending=False):
            handed.append((pc, qcodes, ids, ascending))
            return code_hamming(pc, qcodes, ids, ascending)

        routing.code_hamming = hamming_spy
        before = read_launches()["code_hamming"]
        try:
            got = idx.route_batch(qc, qk)
        finally:
            routing.code_hamming = code_hamming
        require(len(handed) == 1, f"{len(handed)} code_hamming calls")
        require(read_launches()["code_hamming"] == before + 1,
                "one code_hamming call is not one counted launch")
        pc, hq, hids, ascending = handed.pop()
        n_rows, c_words = pc.shape
        picked = ch_mod.choose_path(*hids.shape, n_rows, c_words, ascending)
        require(ascending and picked == "sweep", f"the first batch took the "
                f"{picked} path (ascending={ascending})")
        for nq in (64, 8, 1):
            sq, sid = hq[:nq].contiguous(), hids[:nq].contiguous()
            distinct, nbytes, bound = hamming_bound(n_rows, c_words, sq, sid)
            turns = time_hamming_paths(pc, sq, sid)
            ms = {k: sum(t) / len(t) for k, t in turns.items()}
            path = ch_mod.choose_path(nq, sid.shape[1], n_rows, c_words,
                                      ascending)
            gathered = int(((sid >= 0) & (sid < n_rows)).sum())
            log(f"  code_hamming on the first batch's candidates, first "
                f"{nq} q x {sid.shape[1]} ids: {gathered} valid "
                f"({gathered * c_words * 4} gathered bytes), {distinct} "
                f"distinct rows; bytes read once {nbytes}, bound "
                f"{bound:.4f} ms at {HBM_BYTES / 1e12:.2f} TB/s; gather "
                f"{ms['gather']:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns['gather'])}), sweep "
                f"{ms['sweep']:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns['sweep'])}); the "
                f"wrapper picks {path}: {ms[path]:.4f} ms, at "
                f"{bound / ms[path]:.1%} of the bound")
        del pc, hq, hids, sq, sid
        want = routing.route_rerank(
            partition.table_to(idx.table, "cpu"), coding.words_to_torch(qc),
            torch.from_numpy(qk), idx._tombstones().cpu(),
            idx.point_codes.cpu(), rt.effective_probes(), rt.rerank_limit)
        for f in ("ids", "scores", "n_unique", "n_raw"):
            require(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
                    ("1M route", f))
        log(f"  first batch at {N_SLICE} rows: CUDA route == CPU route on "
            f"every field ({want.n_raw.float().mean():.0f} live probed ids "
            f"per query before dedup)")
        # approx=True at the probe point: the re-rank's pool is too narrow
        # for the TPU's reduction (r == 0), so it is the exact route
        g, _, block = idx.table.ids.shape
        width = g * rt.effective_probes() * block
        wr = reduction_output_size(width, rt.rerank_limit)
        require(wr[1] == 0, f"the re-rank pool of {width} is reduced: {wr}")
        approx = routing.route_rerank(
            idx.table, coding.words_to_torch(qc, dev),
            torch.from_numpy(qk).to(dev), idx._tombstones(), idx.point_codes,
            rt.effective_probes(), rt.rerank_limit, approx=True)
        for f in ("ids", "scores", "n_unique", "n_raw"):
            require(torch.equal(getattr(approx, f), getattr(got, f)),
                    ("approx re-rank", f))
        log(f"  route_rerank(approx=True) over the first batch's pool of "
            f"{width} (W, r = {wr}: no reduction) == the exact route on "
            f"every field")
        require(r10 >= 0.65, f"recall@10 {r10} < 0.65")
        require(ratio <= 1.03, f"ratio@100 {ratio} > 1.03")
        if profile:
            _profile_pass(sys_, queries, gtm, base)
        sys_.shutdown()
    finally:
        refine_mod.refine = plain_refine
        shutil.rmtree(work, ignore_errors=True)
    return counts

FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")
CLI_ROWS, CLI_QUERIES = 100_000, 256
# set from the first run (NVIDIA H100 80GB HBM3, 700 W): recall@10 0.9859
CLI_RECALL_GATE = 0.98


def phase_packed(dev, unpacked_ms: float) -> None:
    """Phase 9: the packed scan state and the row update on CUDA against
    the CPU, the unpacked scan and the native host scan, at phase 4's
    inputs."""
    from fspann_tpu_torch.ops import coding, native_scan
    from fspann_tpu_torch.ops import hamming_scan as hs

    codes, qcodes, tomb, cb = scan_inputs()
    n = len(codes)
    qbits = torch.from_numpy(hs.unpack_bits_numpy(qcodes, cb)).to(dev)
    tb = torch.from_numpy(tomb).to(dev)
    host = hs.build_scan_state_packed(codes, cb, device="cpu")
    packed = hs.build_scan_state_packed(codes, cb, device=dev)
    require(packed.words.dtype == torch.int32
            and packed.words.device.type == torch.device(dev).type,
            "packed words")
    require(torch.equal(host.words, packed.words.cpu()), "words CUDA != CPU")
    require(torch.equal(host.popc, packed.popc.cpu()), "popc CUDA != CPU")
    flat = hs.build_scan_state(codes, cb, device=dev)
    # the exact top-L: the approximate one selects over each chunk's own
    # width, so flat and chunked differ there (phase 16)
    adaptive = dict(anchor=100, margin=40)
    kw = dict(approx=False, **adaptive)
    chunked = dict(chunk=32_768, code_bits=cb, **kw)
    for q in (64, 7, 1):
        want = hs.scan(flat, qbits[:q], tb, 2000, **kw)
        # 100,000 = 3 x 32,768 + 1,696 (a tail under L, re-read from
        # n - chunk) = 3 x 30,000 + 10,000 (a tail scanned as it is)
        for chunk in (32_768, 30_000):
            got = hs.scan_chunked(packed, qbits[:q], tb, 2000,
                                  **{**chunked, "chunk": chunk})
            for f in FIELDS:
                require(torch.equal(getattr(got, f), getattr(want, f)),
                        ("packed", q, chunk, f))
    want = hs.scan(flat, qbits, tb, 2000, **kw)

    # live rows written into zero padding in place == a fresh build
    cut = n - 4096
    st = hs.build_scan_state_packed(
        np.concatenate([codes[:cut], np.zeros_like(codes[cut:])]), cb,
        device=dev)
    ptr, shape = st.words.data_ptr(), st.words.shape
    words = hs.update_rows(st.words, coding.words_to_torch(codes[cut:], dev),
                           cut)
    popc = hs.update_rows(st.popc, host.popc[cut:].to(dev), cut)
    require(words.data_ptr() == ptr and words.shape == shape,
            "update_rows moved or reshaped the words")
    got = hs.scan_chunked(hs.PackedScanState(words, popc), qbits, tb, 2000,
                          **chunked)
    for f in FIELDS:
        require(torch.equal(getattr(got, f), getattr(want, f)),
                ("update_rows", f))
    del st, words, popc, got

    # the native host kernel against the CUDA scan
    t0 = time.perf_counter()
    nat = native_scan.scan_topl(codes, qcodes, tomb, 2000, **adaptive)
    native_ms = (time.perf_counter() - t0) * 1e3
    for f in FIELDS:
        require(np.array_equal(getattr(nat, f), getattr(want, f).cpu()
                               .numpy()), ("native", f))
    ms_chunk = time_ms(lambda: hs.scan_chunked(packed, qbits, tb, 2000,
                                               **chunked))
    ms_route = time_ms(lambda: hs.scan_chunked(packed, qbits, tb, 2000,
                                               code_bits=cb, **kw))
    del want, nat
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hs.scan_chunked(packed, qbits, tb, 2000, code_bits=cb, **kw)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - held
    log(f"phase 9 packed scan 100k x 3072 bits, approx=False: words int32 "
        f"{tuple(packed.words.shape)} ({packed.words.numel() * 4 / 1e6:.1f}"
        f" MB vs {flat.bits.numel() / 1e6:.1f} MB unpacked), CUDA == CPU; "
        f"packed chunked == unpacked flat on every field, Q in (64, 7, 1); "
        f"update_rows in place == fresh build; native host == CUDA at Q=64. "
        f"Q=64: packed {ms_route:.3f} ms (default chunk: one block), "
        f"{ms_chunk:.3f} ms (chunk 32768), unpacked flat {unpacked_ms:.3f} "
        f"ms (phase 4), native host {native_ms:.1f} ms "
        f"({native_scan._num_threads()} thread(s)); one packed scan's "
        f"scratch above what is resident: {scratch / 2**20:.1f} MiB "
        f"({n * 384 / 2**20:.1f} MiB of word bytes, 8x that of bits)")
    del flat, packed
    torch.cuda.empty_cache()


def serve_packed(dev, label: str, cfg, db: str, d: int, n: int, codes,
                 base, queries, gtm, recall10: float,
                 unpacked: dict) -> tuple:
    """Phases 10 and 19: the ``n``-row store in ``db`` restored into the
    packed, capacity-padded layout ``cfg`` names, and served with the
    gates, its serving peak under ``unpacked["peak_serve"]`` (the unpacked
    point's); every batch's route equal to ``scan_chunked(approx=True)``
    over ``codes`` (the unpacked build's) unpacked into the same rows, and
    with approx=False to the unpacked point's exact route of the batch
    (``unpacked["exact"]``).  ``gtm`` None: the ground truth is computed
    here, on the path.  Returns the system and the path's kernel counts,
    read right after the served pass: the restore, the ground truth, the
    warm-up and the 16 batches."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.io import groundtruth
    from fspann_tpu_torch.ops import hamming_scan as hs

    cap = cfg.runtime.scan_capacity_rows
    stale, left = release_earlier_phases()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                   # counts from here are the path's
    sys_ = ForwardSecureANNSystem(cfg, db, d, query_batch=64, device=dev)
    t0 = time.perf_counter()
    restored = sys_.restore_index_from_disk()
    t_restore = time.perf_counter() - t0
    idx = sys_.index
    st = idx._scan_state
    require(restored == n and isinstance(st, hs.PackedScanState),
            f"{label}: restored {restored} into {type(st).__name__}")
    require(st.words.device.type == torch.device(dev).type
            and st.words.dtype == torch.int32 and st.words.shape[0] == cap,
            (label, st.words.device, st.words.shape))
    log(f"  packed: restore of {n} rows {t_restore:.2f} s into "
        f"{tuple(st.words.shape)} int32 words on {st.words.device}, "
        f"{st.words.numel() * 4 / 1e9:.3f} GB (unpacked bits: "
        f"{n * codes[0].nbytes * 8 / 1e9:.2f} GB); earlier phases' "
        f"systems held {stale / 2**30:.2f} GiB of device memory until the "
        f"cycle collector ran, {left / 2**30:.2f} GiB after")
    if gtm is None:
        gtm = groundtruth.precompute(base, queries, k=100, backend="kernel",
                                     device=dev)
    sv = serve_gated(sys_, f"{label} packed", queries, gtm, base, recall10)
    require(sv["peak"] < unpacked["peak_serve"], f"{label}: the packed "
            f"serving peak {sv['peak']} is not under the unpacked one "
            f"{unpacked['peak_serve']}")

    # the served route == scan_chunked(approx=True) over the same codes
    # unpacked into the same rows; with approx=False == the unpacked exact
    # route
    cb, rt = idx.cfg.paper.code_bits, idx.cfg.runtime
    limit = rt.effective_refinement()
    per_batch = scan_launches(cap, limit, 1 << 19)
    flat = hs.build_scan_state(np.concatenate(
        [codes, np.zeros((cap - n,) + codes.shape[1:], codes.dtype)]), cb,
        device=dev)
    tomb = idx._tombstones_scan()
    adaptive = dict(anchor=rt.adaptive_decrypt_anchor,
                    margin=rt.adaptive_decrypt_margin,
                    floor=rt.adaptive_decrypt_floor)
    before = read_launches()["approx_topk"]
    for b, s in enumerate(range(0, Q_SLICE, 64)):
        qc, qk = idx.encode_queries(queries[s:s + 64])
        got = idx.route_batch(qc, qk)
        qbits = torch.from_numpy(hs.unpack_bits_numpy(qc, cb)).to(dev)
        want = hs.scan_chunked(flat, qbits, tomb, limit, **adaptive)
        for f in FIELDS:
            require(torch.equal(getattr(got, f), getattr(want, f)),
                    (f"{label}: served packed route vs chunked scan of the "
                     "bits", s, f))
        ex = to_host(exact_route(idx, queries[s:s + 64]))
        for f in ("ids", "scores", "n_unique", "n_dec"):
            require(np.array_equal(ex[f], unpacked["exact"][b][f]),
                    (f"{label}: exact packed route vs the unpacked one", s, f))
    twins = read_launches()["approx_topk"] - before
    require(twins == 2 * Q_SLICE // 64 * per_batch,
            f"{label}: {twins} approx_topk launches for {Q_SLICE // 64} "
            f"served batches and their twins")
    del flat, tomb, got, want
    torch.cuda.empty_cache()
    require(sv["counts"]["approx_topk"] == (1 + Q_SLICE // 64) * per_batch,
            f"{label}: {sv['counts']['approx_topk']} approx_topk launches "
            f"for the warm-up and {Q_SLICE // 64} served batches")
    b0 = idx.encode_queries(queries[:64])
    call_ms = time_ms(lambda: idx.route_batch(*b0), reps=3)
    route_ms = time_ms(scan_call(idx, queries[:64]), reps=3)
    log(f"  packed: peak device memory while serving {sv['peak'] / 2**30:.2f}"
        f" GiB (unpacked {unpacked['peak_serve'] / 2**30:.2f} GiB); served "
        f"route of every batch == scan_chunked(approx=True) over the same "
        f"codes unpacked into the same {cap} rows, every field ({per_batch} "
        f"approx_topk launches a batch: chunks of 2^19 rows, the "
        f"{cap - (cap // (1 << 19)) * (1 << 19)}-row tail not reduced); with "
        f"approx=False == the unpacked exact route; packed scan of one batch "
        f"of 64 on inputs on the card: {route_ms:.3f} ms (CUDA events); "
        f"route_batch from host codes: {call_ms:.3f} ms")
    return sys_, sv["counts"]


def phase_lifecycle(dev, work, base, queries, p5: dict) -> tuple[dict, dict]:
    """Phase 10: phase 5's store restored into a packed, capacity-padded
    system; serve, live insert in place and past capacity, delete, rotate,
    flush, restore into the same layout and unpacked.  Returns the kernel
    counts and the unpacked restore's exact CUDA route of the first batch
    (for phase 11)."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.io import synthetic
    from fspann_tpu_torch.ops import hamming_scan as hs

    db = os.path.join(work, "db")
    cap = N_SLICE + 65_536
    extra, _ = synthetic.lsh_hard_corpus(5 * 16_384, 128, 1, seed=43)
    new_ids = N_SLICE + np.arange(len(extra), dtype=np.int64)
    log(f"phase 10 lifecycle at {N_SLICE}: phase 5's store, packed at "
        f"capacity {cap}")
    sys_, served = serve_packed(
        dev, "phase 10", slice_cfg(scan_packed="on", scan_capacity_rows=cap),
        db, 128, N_SLICE, p5["codes"], base, queries, None, 0.98, p5)
    require(served["l2_topk"] > 0, "ground truth did not run l2_topk")
    idx = sys_.index
    st = idx._scan_state

    # the lifecycle: counts from here are the path's again
    reset_launches()
    ptr, shape = st.words.data_ptr(), tuple(st.words.shape)
    ms = []
    for i in range(4):
        sl = slice(i * 16_384, (i + 1) * 16_384)
        t0 = time.perf_counter()
        sys_.insert_live(new_ids[sl], extra[sl])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        w = idx._scan_state.words
        require(w.data_ptr() == ptr and tuple(w.shape) == shape,
                f"insert {i} moved the words")
    t0 = time.perf_counter()
    sys_.insert_live(new_ids[4 * 16_384:], extra[4 * 16_384:])
    torch.cuda.synchronize()
    grow_ms = (time.perf_counter() - t0) * 1e3
    require(idx._n_rows == N_SLICE + len(extra), idx._n_rows)
    require(idx._scan_rows >= N_SLICE + len(extra) + 4096, idx._scan_rows)
    log(f"  insert_live 4 x 16384 in place: "
        f"{', '.join(f'{m:.1f}' for m in ms)} ms (words storage and shape "
        f"kept); 16384 past capacity: {grow_ms:.1f} ms, state grew to "
        f"{idx._scan_rows} rows")

    pick = np.random.default_rng(5).choice(len(extra), 64, replace=False)
    got = serve(sys_, extra[pick], k=10)[0]
    require((got[:, 0] == new_ids[pick]).all(), "appended rows not first")
    gone = new_ids[pick[:32]]
    sys_.delete(gone)
    got = serve(sys_, extra[pick])[0]
    require(not np.isin(got, gone).any(), "deleted rows returned")
    require((got[32:, 0] == new_ids[pick[32:]]).all(), "kept rows lost")

    probe = queries[:64]
    before = serve(sys_, probe)
    # a restore pins the key version for query-only serving; this system
    # takes writes, so it releases the pin before rotating
    sys_.rotation.pinned_version = None
    t0 = time.perf_counter()
    rep = sys_.run_selective_reencryption()
    t_rot = time.perf_counter() - t0
    require(rep.get("new_version", 0) > rep.get("old_version", 0)
            and rep.get("reencrypted", 0) > 0, f"no rotation: {rep}")
    require_same(serve(sys_, probe), before, "after rotation")
    t0 = time.perf_counter()
    sys_.flush_all()
    t_flush = time.perf_counter() - t0
    grown = idx._scan_rows
    first = exact_route(idx, queries[:64])
    sys_.shutdown()
    del sys_, st, w, idx

    # restored into the layout it was served from (packed, the grown row
    # count): the same approximate selection, so the same results
    back = ForwardSecureANNSystem(
        slice_cfg(scan_packed="on", scan_capacity_rows=grown,
                  scan_native="off"), db, 128, query_batch=64)
    back_n = back.restore_index_from_disk()
    require(back_n == N_SLICE + len(extra) - len(gone), back_n)
    require(back.index._scan_rows == grown, back.index._scan_rows)
    require_same(serve(back, probe), before, "after flush and restore")
    back.shutdown()
    # restored unpacked: the exact route is the one before the flush
    back = ForwardSecureANNSystem(slice_cfg(scan_native="off"), db, 128,
                                  query_batch=64)
    require(back.restore_index_from_disk() == back_n, "unpacked restore")
    require(isinstance(back.index._scan_state, hs.ScanState), "not unpacked")
    again = exact_route(back.index, queries[:64])
    for f in ("ids", "scores", "n_unique", "n_dec"):
        require(np.array_equal(getattr(first, f).cpu().numpy(),
                               getattr(again, f).cpu().numpy()),
                ("exact route after flush and unpacked restore", f))
    cuda_route = {f: getattr(again, f).cpu().numpy() for f in FIELDS}
    back.shutdown()
    counts = {k: v + served[k] for k, v in read_launches().items()}
    log(f"  self search of 64 appended rows: own id first; 32 deleted, "
        f"never returned; rotation v{rep['old_version']} -> "
        f"v{rep['new_version']} re-encrypted {rep['reencrypted']} in "
        f"{t_rot:.2f} s, 64 queries unchanged; flush_all {t_flush:.2f} s; "
        f"restore of {back_n} live rows into the served layout ({grown} "
        f"rows, packed): results unchanged; unpacked restore: exact route "
        f"unchanged; kernel launches on this path {counts}")
    torch.cuda.empty_cache()
    return counts, cuda_route


def phase_native(work, queries, cuda_route) -> None:
    """Phase 11: the same store served by the native host scan (exact);
    its first batch's route equals the CUDA scan's with approx=False."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.ops import native_scan

    sys_ = ForwardSecureANNSystem(slice_cfg(scan_native="on"),
                                  os.path.join(work, "db"), 128,
                                  query_batch=64)
    try:
        n = sys_.restore_index_from_disk()
        require(sys_.index._scan_state is None, "a device state was built")
        qc, qk = sys_.index.encode_queries(queries[:64])
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = sys_.index.route_batch(qc, qk)
            ms.append((time.perf_counter() - t0) * 1e3)
        for f in FIELDS:
            a = getattr(got, f)
            require(isinstance(a, np.ndarray) and
                    np.array_equal(a, cuda_route[f]), ("native", f))
    finally:
        sys_.shutdown()
    log(f"phase 11 native host scan over {n} live rows "
        f"({sys_.index._n_rows} scanned), Q=64: route == exact CUDA route on "
        f"every field; {ms[0]:.1f}, {ms[1]:.1f} ms per batch at "
        f"{native_scan._num_threads()} thread(s) on {os.cpu_count()} cores")


def write_fvecs(path: str, x: np.ndarray) -> None:
    n, d = x.shape
    out = np.empty((n, d + 1), "<f4")
    out[:, 0] = np.array(d, "<i4").view("<f4")
    out[:, 1:] = x
    out.tofile(path)


def run_cli(argv) -> dict:
    """``fspann_tpu_torch.api.cli.main`` in this process; its last line of
    standard output (a JSON object) parsed."""
    from fspann_tpu_torch.api import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    require(rc == 0, f"cli exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_cli(base, queries, work) -> dict:
    """Phase 12: the command-line entry point, full run with --gt AUTO and
    then --query-only against the ground truth saved as ivecs."""
    from fspann_tpu_torch.io import groundtruth

    d = os.path.join(work, "cli")
    os.makedirs(d)
    write_fvecs(os.path.join(d, "base.fvecs"), base[:CLI_ROWS])
    write_fvecs(os.path.join(d, "q.fvecs"), queries[:CLI_QUERIES])
    common = ["--queries", os.path.join(d, "q.fvecs"),
              "--config", os.path.join(os.path.dirname(
                  os.path.abspath(__file__)), "configs", "hard1m.json"),
              "--profile", "HARD_SCAN", "--base-dir", os.path.join(d, "db"),
              "--query-limit", str(CLI_QUERIES)]
    reset_launches()                   # counts from here are the path's
    t0 = time.perf_counter()
    full = run_cli(common + ["--data", os.path.join(d, "base.fvecs"),
                             "--gt", "AUTO",
                             "--results", os.path.join(d, "res")])
    t_full = time.perf_counter() - t0
    counts = read_launches()
    require(counts["l2_topk"] > 0, "--gt AUTO did not run l2_topk")
    gt = os.path.join(d, "gt.ivecs")
    groundtruth.precompute(base[:CLI_ROWS], queries[:CLI_QUERIES], k=100,
                           backend="kernel").save_ivecs(gt)
    reset_launches()                   # the query-only run's own counts
    t0 = time.perf_counter()
    again = run_cli(common + ["--query-only", "--gt", gt, "--no-reencrypt",
                              "--results", os.path.join(d, "res2")])
    t_again = time.perf_counter() - t0
    counts = {k: v + read_launches()[k] for k, v in counts.items()}
    for out in (full, again):
        require(out["queries"] == CLI_QUERIES, out)
        require(out["recall_at_10"] is not None
                and out["recall_at_10"] >= CLI_RECALL_GATE, out)
    require(again["recall_at_10"] == full["recall_at_10"],
            f"query-only recall {again} != full run {full}")
    log(f"phase 12 cli (HARD_SCAN, {CLI_ROWS} rows, {CLI_QUERIES} q): full "
        f"run {t_full:.1f} s {json.dumps(full)}; --query-only "
        f"{t_again:.1f} s {json.dumps(again)}; gate recall@10 >= "
        f"{CLI_RECALL_GATE}; kernel launches on this path {counts}")
    return counts

SHARD_L, SHARD_CAP = 2000, N_SLICE + 65_536
# the probe point of phases 13 and 17: 16 probes, re-rank to L
SHARD_PROBE = dict(probes=16, refinement_limit=56_000, rerank_limit=SHARD_L)
_POPC8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1) \
    .sum(axis=1)


def differing_bits(a: np.ndarray, b: np.ndarray) -> int:
    """Bits in which two uint32 word arrays of one shape differ."""
    x = np.bitwise_xor(a, b)
    return int(_POPC8[x.view(np.uint8)].sum()) if x.any() else 0


def f16_round_trip(x: np.ndarray) -> np.ndarray:
    """What an f16 store decodes: the vectors phase 5's index was coded on."""
    return x.astype(np.float16).astype(np.float32)


def scan_routes(idx, queries, **kw) -> tuple[np.ndarray, np.ndarray]:
    """The sharded scan route of ``queries`` in batches of 64."""
    out = [idx.scan_route(queries[s:s + 64], limit=SHARD_L, **kw)
           for s in range(0, len(queries), 64)]
    return tuple(np.concatenate([o[i] for o in out]) for i in (0, 1))


def phase_sharded(dev, base, queries, work, p5) -> tuple[dict, dict]:
    """Phase 13: the sharded index at 1M on the card.  Returns the kernel
    counts and what phases 14 and 17 compare with: the exact and the
    approximate (default) scan route of every query at 4 shards and the
    first batch's probe route with the re-rank."""
    from fspann_tpu_torch.io import synthetic
    from fspann_tpu_torch.ops import code_hamming as ch_mod
    from fspann_tpu_torch.ops import coding, routing
    from fspann_tpu_torch.ops import hamming_scan as hs
    from fspann_tpu_torch.ops.approx_topk import reduction_output_size
    from fspann_tpu_torch.ops.code_hamming import code_hamming
    from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh

    bank = p5["bank"]
    cb = bank.code_bits
    base_q = f16_round_trip(base)
    release_earlier_phases()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                   # counts from here are the path's

    def build(nd, layout, keep_codes=False, capacity=SHARD_CAP):
        idx = ShardedIndex(make_mesh(nd, device=dev), bank, block_size=128)
        t0 = time.perf_counter()
        idx.build(base_q, keep_base=False, keep_codes=keep_codes,
                  keep_bits=layout, capacity=capacity)
        torch.cuda.synchronize()
        return idx, time.perf_counter() - t0

    # device encode against phase 5's host encode, and the single-device
    # scan over the sharded index's own codes: the reference of every route
    a4, t_a4 = build(4, True, keep_codes=True)
    require(a4.bits[0].is_cuda and a4.table[0].ids.is_cuda
            and a4.tombs[0].is_cuda, "sharded state not on the card")
    codes = coding.words_to_numpy(a4.point_codes[0][:N_SLICE])
    flips = differing_bits(codes, p5["codes"])
    qwords = coding.encode(torch.from_numpy(queries).to(dev),
                           coding.bank_to(bank, dev))[0]
    qflips = differing_bits(coding.words_to_numpy(qwords),
                            coding.encode_numpy(queries, bank)[0])
    state = hs.build_scan_state(codes, cb, device=dev)
    no_tomb = torch.zeros(N_SLICE, dtype=torch.bool, device=dev)
    want = [hs.scan(state, hs.unpack_bits_device(qwords[s:s + 64], cb),
                    no_tomb, SHARD_L, approx=False)
            for s in range(0, Q_SLICE, 64)]
    want = tuple(np.concatenate([getattr(r, f).cpu().numpy() for r in want])
                 for f in ("ids", "scores"))
    del state, no_tomb
    torch.cuda.empty_cache()
    log(f"phase 13 sharded index {N_SLICE}x128 on {dev}, 3072-bit codes, "
        f"capacity {SHARD_CAP}: device encode differs from phase 5's host "
        f"encode in {flips} of {codes.size * 32} corpus bits and {qflips} "
        f"query bits")
    if flips == 0 and qflips == 0:
        require_same(want, p5["route"], "single-device scan over the "
                     "sharded codes vs phase 5's route")
        log(f"  single-device scan over the sharded index's codes == phase "
            f"5's route of the {Q_SLICE} queries at L={SHARD_L}")
    else:
        same = float((want[0] == p5["route"][0]).mean())
        log(f"  the encoders differ, so phase 5's route is no reference: "
            f"{same:.6f} of its ids are equal")

    # every combination: shards x layout x merge, the exact top-L (the
    # approximate one selects over each shard's or chunk's own width);
    # device ms per batch of 64 of the default (approximate) route
    ms, secs, kept = {}, {(4, True): t_a4}, {(4, True): a4}
    batch0 = queries[:64]
    for nd in (4, 8, 1):
        for layout in (True, "packed"):
            idx = kept.get((nd, layout))
            if idx is None:
                idx, secs[nd, layout] = build(nd, layout)
            for merge in ("ici", "host"):
                idx.merge_backend = merge
                require_same(scan_routes(idx, queries, approx=False), want,
                             f"sharded scan, {nd} shards, "
                             f"{'packed' if layout == 'packed' else 'bits'}, "
                             f"merge {merge}")
                ms[nd, layout, merge] = time_ms(
                    lambda: idx.scan_route_dispatch(batch0, limit=SHARD_L),
                    reps=5)
            idx.merge_backend = "ici"
            if nd == 4:
                kept[nd, layout] = idx
            else:
                del idx
                torch.cuda.empty_cache()
    b4 = kept[4, "packed"]
    lay = {True: "unpacked", "packed": "packed"}

    # the default (approx=True) at 4 shards: each shard's top-L selected by
    # the approx_topk kernel over its own rows (r 1), merged exactly; the
    # packed layout scans a shard as one chunk, so it selects the same
    before = read_launches()["approx_topk"]
    approx = scan_routes(a4, queries)
    require(read_launches()["approx_topk"] == before + 4 * Q_SLICE // 64,
            "the 4-shard scan did not launch approx_topk once per shard and "
            "batch")
    require_same(scan_routes(a4, queries, approx=True), approx,
                 "approx=True vs the default")
    require_same(scan_routes(b4, queries), approx,
                 "packed vs unpacked approx scan")
    share = retained_share(approx[0], want[0])
    require(share.mean() >= APPROX_SHARE_GATE,
            f"4-shard approx scan kept {share.mean():.4f}")
    exact_ms = time_ms(lambda: a4.scan_route_dispatch(batch0, limit=SHARD_L,
                                                      approx=False), reps=5)
    log(f"  the default, approx=True, at 4 shards ({a4.shard_rows} rows a "
        f"shard: W, r = {reduction_output_size(a4.shard_rows, SHARD_L)}), "
        f"unpacked == packed: share of the exact top-{SHARD_L} kept mean "
        f"{share.mean():.6f} min {share.min():.6f} (gate: mean >= "
        f"{APPROX_SHARE_GATE}); {ms[4, True, 'ici']:.3f} ms per batch of 64 "
        f"(approx=False {exact_ms:.3f})")
    log(f"  scan route of {Q_SLICE} q at L={SHARD_L}, approx=False == the "
        f"single-device scan, ids and scores, at 1, 4 and 8 shards x "
        f"unpacked, packed x merge on the device, on the host")
    log("  build s: " + ", ".join(
        f"{nd} shards {lay[la]} {t:.2f}" for (nd, la), t in secs.items()))
    log("  device ms per batch of 64 of the default (approximate) route "
        "(CUDA events; query upload, device encode, per-shard scan, merge, "
        "pinned copy): " + "; ".join(
            f"{nd} shards {lay[la]} {ms[nd, la, 'ici']:.3f} (host merge "
            f"{ms[nd, la, 'host']:.3f})" for nd in (1, 4, 8)
            for la in (True, "packed")))

    # streamed build == one-shot build (tables and route), both without
    # capacity: the one-shot build pads with copies of the last row, the
    # stream with zero rows, and the tables hold the (masked) pad rows
    one, _ = build(4, True, capacity=None)
    st = ShardedIndex(make_mesh(4, device=dev), bank, block_size=128)
    t0 = time.perf_counter()
    total = st.build_stream(
        (base_q[s:s + 100_000] for s in range(0, N_SLICE, 100_000)), N_SLICE,
        keep_bits=True)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    require(total == N_SLICE and st.shard_rows == one.shard_rows, total)
    for f in one.table[0]._fields:
        x, y = getattr(one.table[0], f), getattr(st.table[0], f)
        require((x is None and y is None) or torch.equal(x, y),
                ("streamed table", f))
    require(torch.equal(st.bits[0], one.bits[0])
            and torch.equal(st.popc[0], one.popc[0]), "streamed scan state")
    require_same(scan_routes(st, queries, approx=False), want,
                 "streamed build's route")
    log(f"  build_stream in 100000-row chunks {t_stream:.2f} s: stacked "
        f"tables {tuple(st.table[0].ids.shape)}, scan state and route == "
        f"the one-shot build's")
    del st, one
    torch.cuda.empty_cache()

    # probe route with the re-rank at 4 shards against CPU copies
    host = ShardedIndex(make_mesh(4, device="cpu"), bank, block_size=128)
    host.n, host.shard_rows = a4.n, a4.shard_rows
    host.table = [type(t)(*(None if f is None else f.cpu() for f in t))
                  for t in a4.table]
    host.point_codes = [p.cpu() for p in a4.point_codes]
    host.tombs = [p.cpu() for p in a4.tombs]
    paths = []

    def hamming_spy(pc, qcodes, ids, ascending=False):
        paths.append(ch_mod.choose_path(*ids.shape, *pc.shape, ascending))
        return code_hamming(pc, qcodes, ids, ascending)

    probe = SHARD_PROBE
    routing.code_hamming = hamming_spy
    before = read_launches()["code_hamming"]
    try:
        got = a4.route(batch0, **probe)
    finally:
        routing.code_hamming = code_hamming
    require(read_launches()["code_hamming"] == before + 4 and len(paths) == 4,
            f"{len(paths)} code_hamming calls for 4 shards")
    # the CPU copy routes the codes the card encoded: the comparison is
    # of the route; the two encoders' difference is printed beside it
    qc0, qk0 = coding.encode(torch.from_numpy(batch0).to(dev),
                             coding.bank_to(bank, dev))
    cpu_flips = differing_bits(
        coding.words_to_numpy(qc0),
        coding.words_to_numpy(coding.encode(torch.from_numpy(batch0),
                                            bank)[0]))
    device_encode = coding.encode
    coding.encode = lambda x, b: (qc0.cpu(), qk0.cpu())
    t0 = time.perf_counter()
    try:
        require_same(got, host.route(batch0, **probe), "probe route vs CPU")
    finally:
        coding.encode = device_encode
    t_cpu = time.perf_counter() - t0
    probe_ms = time_ms(lambda: a4.route_dispatch(batch0, **probe), reps=3)
    del host
    log(f"  probe route (16 probes, re-rank to {SHARD_L}) of the first "
        f"batch at 4 shards == the same route on CPU copies of the state "
        f"({t_cpu:.1f} s there; torch's CPU encode of the batch differs "
        f"from the card's in {cpu_flips} bits); code_hamming once per shard "
        f"over "
        f"{a4.shard_rows} rows: paths {paths}; {probe_ms:.3f} ms of device "
        f"time per batch")

    # deletes leave every route
    gone = np.intersect1d(got[0][got[0] >= 0], want[0][:64])[:32] \
        .astype(np.int64)
    require(len(gone) == 32, "fewer than 32 ids in both routes")
    tombs_ptr = a4.tombs[0].data_ptr()
    for idx in (a4, b4):
        idx.mark_deleted(gone)
    require(a4.tombs[0].data_ptr() == tombs_ptr,
            "mark_deleted moved the mask")
    for name, res in (("scan", a4.scan_route(batch0, limit=SHARD_L)),
                      ("packed scan", b4.scan_route(batch0, limit=SHARD_L)),
                      ("probe", a4.route(batch0, probes=16,
                                         refinement_limit=56_000)),
                      ("re-rank", a4.route(batch0, **probe))):
        require(not np.isin(res[0], gone).any(), f"{name}: deleted id")
    require(np.isin(want[0][:64], gone).any(), "the deletes hit no result")

    # live inserts in place, found by self search
    extra, _ = synthetic.lsh_hard_corpus(4 * 16_384, 128, 1, seed=43)
    extra = f16_round_trip(extra)
    ptrs = [(i.words if i.words is not None else i.bits)[0].data_ptr()
            for i in (a4, b4)] + [a4.popc[0].data_ptr(), b4.popc[0].data_ptr()]
    ins_ms = []
    for i in range(4):
        sl = slice(i * 16_384, (i + 1) * 16_384)
        for idx in (a4, b4):
            t0 = time.perf_counter()
            ids = idx.append_scan_rows(extra[sl])
            torch.cuda.synchronize()
            ins_ms.append((time.perf_counter() - t0) * 1e3)
            require(ids[0] == N_SLICE + sl.start and len(ids) == 16_384, ids)
    require([(i.words if i.words is not None else i.bits)[0].data_ptr()
             for i in (a4, b4)] + [a4.popc[0].data_ptr(),
                                   b4.popc[0].data_ptr()]
            == ptrs, "append_scan_rows moved the scan state")
    require(a4.n == b4.n == N_SLICE + len(extra) and a4.point_codes is None,
            (a4.n, b4.n))
    pick = np.random.default_rng(5).choice(len(extra), 64, replace=False)
    for idx in (a4, b4):
        res = idx.scan_route(extra[pick], limit=SHARD_L)
        require((res[0][:, 0] == N_SLICE + pick).all(),
                "appended rows not first")
        require(not np.isin(res[0], gone).any(), "deleted id after insert")
    require_same(b4.scan_route(batch0, limit=SHARD_L),
                 a4.scan_route(batch0, limit=SHARD_L),
                 "packed vs unpacked after inserts")

    # checkpoint: save_state -> restore_state reproduces the route
    path = os.path.join(work, "mesh_state.npz")
    t0 = time.perf_counter()
    b4.save_state(path)
    t_save = time.perf_counter() - t0
    after = scan_routes(a4, queries[:128])
    del a4
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    back = ShardedIndex.restore_state(path, make_mesh(4, device=dev),
                                      keep_bits="packed")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    back.mark_deleted(gone)
    require(back.n == b4.n and back.words[0].is_cuda, back.n)
    require_same(scan_routes(back, queries[:128]), after, "restored route")
    require(torch.equal(back.words[0], b4.words[0])
            and torch.equal(back.popc[0], b4.popc[0]), "restored words")
    peak = torch.cuda.max_memory_allocated()
    counts = read_launches()
    log(f"  32 deleted ids left the scan, packed scan, probe and re-rank "
        f"routes; 4 x 16384 append_scan_rows in place (storage kept): "
        f"unpacked {', '.join(f'{m:.1f}' for m in ins_ms[0::2])} ms, packed "
        f"{', '.join(f'{m:.1f}' for m in ins_ms[1::2])} ms; own id first "
        f"for 64 appended rows; save_state {t_save:.2f} s "
        f"({os.path.getsize(path) / 1e6:.0f} MB), restore_state "
        f"{t_restore:.2f} s into the packed layout: route and words "
        f"reproduced; peak device memory {peak / 2**30:.2f} GiB; kernel "
        f"launches on this path {counts}")
    del back, b4
    torch.cuda.empty_cache()
    return counts, {"scan": want, "approx": approx, "probe": got}


def phase_distributed(dev, base, queries, work, p5, ref, p13) -> tuple[dict,
                                                                      tuple]:
    """Phase 14: the distributed encrypted facade at 1M, scan mode, 4
    shards, through ``build`` (the one-shot build: the bank's sample is
    phase 5's, the first 100,000 stored rows).  Its scan route is phase
    13's 4-shard route (the default, approximate one; and with
    approx=False the exact one).  Returns the kernel counts and the served
    ids and distances (phase 17 compares with them)."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.io import groundtruth, synthetic
    from fspann_tpu_torch.parallel.serving import DistributedEncryptedSystem
    from fspann_tpu_torch.parallel.sharded import make_mesh

    db = os.path.join(work, "mesh_db")
    cfg = slice_cfg()
    batches = [queries[s:s + 64] for s in range(0, Q_SLICE, 64)]

    def served(sys_, qs, k=100):
        res = sys_.search_batches([qs[s:s + 64]
                                   for s in range(0, len(qs), 64)], k)
        return (np.concatenate([r[0] for r in res]),
                np.concatenate([r[1] for r in res]))

    release_earlier_phases()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                   # counts from here are the path's
    sys_ = DistributedEncryptedSystem(cfg, db, 128, mesh=make_mesh(4, device=dev))
    t0 = time.perf_counter()
    sys_.build(base, sample=100_000, capacity=SHARD_CAP)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    idx = sys_.index
    bank = idx.bank
    same_bank = all(np.array_equal(getattr(bank, f), getattr(p5["bank"], f))
                    for f in ("alpha", "r", "omega"))
    require(same_bank, "the facade's bank is not phase 5's")
    require(idx.bits is not None and idx.bits[0].is_cuda and idx.base is None
            and idx.merge_backend == cfg.runtime.mesh_merge, "facade state")
    per_shard = [len(s.meta) for s in sys_.store.shards]
    require(per_shard == [max(0, min(N_SLICE - s * idx.shard_rows,
                                     idx.shard_rows)) for s in range(4)],
            per_shard)
    gtm = groundtruth.precompute(base, queries, k=100, backend="kernel")
    sys_.search_batch(batches[0], 100)                    # warm-up
    peak_build = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sys_.search_batches(batches, 100)
    wall = time.perf_counter() - t0
    peak_serve = torch.cuda.max_memory_allocated()
    got = (np.concatenate([r[0] for r in res]),
           np.concatenate([r[1] for r in res]))
    counts = read_launches()
    require(counts["l2_topk"] > 0, "ground truth did not run l2_topk")
    # the served route: one approx_topk launch a shard and batch (the
    # warm-up batch and the pass's 16)
    require(counts["approx_topk"] >= 4 * (1 + Q_SLICE // 64),
            f"the served route did not run approx_topk: {counts}")
    require(got[0].shape == (Q_SLICE, 100) and got[0].dtype == np.int64
            and np.isfinite(got[1]).all(), "result shape")
    recalls, ratios = ForwardSecureANNSystem._metrics_block(
        None, np.arange(Q_SLICE), queries, got[0], got[1], (10, 100), gtm,
        base)
    r10, r100 = float(recalls[10].mean()), float(recalls[100].mean())
    ratio = float(ratios[100].mean())
    ids_equal = float((got[0] == ref[0]).mean())
    log(f"phase 14 distributed facade {N_SLICE}x128, scan mode, 4 shards, "
        f"f16 payloads, L={SHARD_L}, margin 40, batch 64: build "
        f"{t_build:.1f} s (bank == phase 5's, fingerprint "
        f"{fingerprint(bank.alpha, bank.r, bank.omega)}; arenas "
        f"{per_shard}); q/s {Q_SLICE / wall:.1f}  ART "
        f"{wall / Q_SLICE * 1e3:.3f} ms  recall@10 {r10:.4f}  recall@100 "
        f"{r100:.4f}  ratio@100 {ratio:.4f}  ids equal to phase 5's "
        f"{ids_equal:.6f}  peak device memory {peak_build / 2**30:.2f} GiB "
        f"(build, ground truth, warm-up), {peak_serve / 2**30:.2f} GiB "
        f"(serving); kernel launches on this path {counts}")
    require(r10 >= 0.98, f"recall@10 {r10} < 0.98")
    require(ratio <= 1.01, f"ratio@100 {ratio} > 1.01")
    # the facade's scan route is phase 13's 4-shard route: the approximate
    # one it serves, and the exact one with approx=False (phase 5's final
    # ids came from the flat scan's selection, another approximation)
    require_same(scan_routes(idx, queries), p13["approx"],
                 "the facade's route vs phase 13's 4-shard route")
    require_same(scan_routes(idx, queries, approx=False), p13["scan"],
                 "the facade's exact route vs phase 13's")
    log(f"  the facade's scan route == phase 13's 4-shard route (the "
        f"default, approximate) and its exact one (approx=False), ids and "
        f"scores of the {Q_SLICE} queries")

    # lifecycle: live insert, delete, rotation, checkpoint, fresh restore
    extra, _ = synthetic.lsh_hard_corpus(16_384, 128, 1, seed=47)
    ptr = idx.bits[0].data_ptr()
    t0 = time.perf_counter()
    new_ids = sys_.insert_live(extra)
    ins_ms = (time.perf_counter() - t0) * 1e3
    require(new_ids[0] == N_SLICE and sys_.n == N_SLICE + len(extra)
            and idx.bits[0].data_ptr() == ptr, "insert_live")
    pick = np.random.default_rng(7).choice(len(extra), 64, replace=False)
    own = served(sys_, extra[pick], k=10)[0]
    require((own[:, 0] == new_ids[pick]).all(), "appended rows not first")
    gone = new_ids[pick[:32]]
    sys_.delete(gone)
    own = served(sys_, extra[pick], k=10)[0]
    require(not np.isin(own, gone).any(), "deleted rows returned")
    require((own[32:, 0] == new_ids[pick[32:]]).all(), "kept rows lost")
    probe = queries[:128]
    before = served(sys_, probe)
    t0 = time.perf_counter()
    rep = sys_.rotate_and_migrate()
    t_rot = time.perf_counter() - t0
    require(rep.reencrypted == sys_.n - len(gone), rep)
    require_same(served(sys_, probe), before, "after rotation")
    t0 = time.perf_counter()
    sys_.save_index()
    t_save = time.perf_counter() - t0
    sys_.close()
    del sys_, idx
    torch.cuda.empty_cache()
    back = DistributedEncryptedSystem(cfg, db, 128, mesh=make_mesh(4, device=dev))
    try:
        t0 = time.perf_counter()
        n_back = back.restore_index()
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        require(n_back == N_SLICE + len(extra), n_back)
        require_same(served(back, probe), before, "fresh restore")
        own = served(back, extra[pick], k=10)[0]
        require(not np.isin(own, gone).any(), "deletes lost in restore")
    finally:
        back.close()
    log(f"  insert_live 16384 rows {ins_ms:.1f} ms (bits storage kept), own "
        f"id first; 32 deleted, never returned; rotate_and_migrate "
        f"re-encrypted {rep.reencrypted} in {t_rot:.2f} s, 128 queries "
        f"unchanged; save_index {t_save:.2f} s; a fresh object's "
        f"restore_index {t_restore:.2f} s serves the same ids and "
        f"distances, deletes re-derived from the stores")
    torch.cuda.empty_cache()
    return counts, got


def multislot_mesh():
    """Phase 17's mesh: 4 shards over min(4, cards) cards (a count that
    divides 4), one slot a card, or 4 slots on the one card."""
    from fspann_tpu_torch.parallel.sharded import make_mesh

    cards = max(c for c in (4, 2, 1) if c <= torch.cuda.device_count())
    slots = [f"cuda:{i}" for i in range(cards)] if cards > 1 \
        else ["cuda:0"] * 4
    return make_mesh(4, devices=slots)


def time_ms_cards(fn, devices, reps: int = 5) -> float:
    """Mean time of ``fn`` over ``reps`` calls that queue work on several
    cards: CUDA events on every card's current stream, the longest span."""
    spans = []
    for d in devices:
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(d))
        spans.append((d, start, torch.cuda.Event(enable_timing=True)))
    for _ in range(reps):
        fn()
    for d, _start, end in spans:
        end.record(torch.cuda.current_stream(d))
    for d in devices:
        torch.cuda.synchronize(d)
    return max(start.elapsed_time(end) for _d, start, end in spans) / reps


def phase_multislot(base, queries, work, refs) -> dict:
    """Phase 17: the sharded index and the facade with their shards on
    their own cards (:func:`multislot_mesh`), held to phases 13 and 14's
    one-slot results: per-slot state, every scan route (unpacked, packed x
    approx off, on x merge on the first card, on the host), the probe
    route with the re-rank, one dispatch of each step under
    ``set_sync_debug_mode("error")`` (no host sync before ``get()``), the
    facade's served ids and distances; then each kernel against its plain
    twin on every distinct card, on inputs of this path."""
    from fspann_tpu_torch.ops import hamming_scan as hs
    from fspann_tpu_torch.ops import routing
    from fspann_tpu_torch.ops.approx_topk import (partial_reduce,
                                                  partial_reduce_plain,
                                                  reduction_output_size)
    from fspann_tpu_torch.ops.code_hamming import (code_hamming,
                                                   code_hamming_gather,
                                                   code_hamming_plain,
                                                   code_hamming_sweep)
    from fspann_tpu_torch.ops.l2_topk import l2_topk
    from fspann_tpu_torch.ops.refine import bruteforce_topk
    from fspann_tpu_torch.parallel.serving import DistributedEncryptedSystem
    from fspann_tpu_torch.parallel.sharded import ShardedIndex

    mesh = multislot_mesh()
    devs = mesh.devices
    peer = {f"{a.index}->{b.index}": torch.cuda.can_device_access_peer(
        a.index, b.index) for a in devs for b in devs if a != b}
    base_q = f16_round_trip(base)
    batch0 = queries[:64]
    release_earlier_phases()
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    reset_launches()                   # counts from here are the path's
    idx, secs = {}, {}
    for layout in (True, "packed"):
        t = ShardedIndex(mesh, refs["bank"], block_size=128)
        t0 = time.perf_counter()
        t.build(base_q, keep_base=False, keep_codes=layout is True,
                keep_bits=layout, capacity=SHARD_CAP)
        for d in devs:
            torch.cuda.synchronize(d)
        secs[layout] = time.perf_counter() - t0
        for name in ("popc", "tombs", "words" if layout == "packed"
                     else "bits"):
            parts = t._per_device(getattr(t, name))
            require([p.device for p in parts] == list(mesh.slots)
                    and all(len(p) == t.shard_rows * mesh.shards_per_slot
                            for p in parts), f"{name}: not one tensor a slot")
        idx[layout] = t
    lay = {True: "unpacked", "packed": "packed"}
    ms = {}
    for layout, t in idx.items():
        for merge in ("ici", "host"):
            t.merge_backend = merge
            for approx in (False, True):
                require_same(scan_routes(t, queries, approx=approx),
                             refs["approx" if approx else "scan"],
                             f"{len(devs)} card(s), {lay[layout]}, merge "
                             f"{merge}, approx {approx}")
            ms[layout, merge] = time_ms_cards(
                lambda: t.scan_route_dispatch(batch0, limit=SHARD_L), devs)
        t.merge_backend = "ici"
    a4 = idx[True]
    hamming_calls = []

    def hamming_spy(pc, qcodes, ids, ascending=False):
        hamming_calls.append((pc, qcodes, ids))
        return code_hamming(pc, qcodes, ids, ascending)

    routing.code_hamming = hamming_spy
    try:
        require_same(a4.route(batch0, **SHARD_PROBE), refs["probe"],
                     "probe route with the re-rank")
    finally:
        routing.code_hamming = code_hamming
    require([c[2].device for c in hamming_calls]
            == [a4._slot_device(s) for s in range(4)],
            "code_hamming not on each shard's card")
    probe_ms = time_ms_cards(lambda: a4.route_dispatch(batch0, **SHARD_PROBE),
                             devs, reps=3)
    # no host sync between the first launch and get(): the step queues every
    # slot's work, the gather and the host copies
    for d in devs:
        torch.cuda.synchronize(d)
    a4.merge_backend = "host"
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [(t.scan_route_dispatch(batch0, limit=SHARD_L, approx=ap),
                    refs["approx" if ap else "scan"], f"{lay[la]} {ap}")
                   for la, t in idx.items() for ap in (False, True)]
        pending.append((a4.route_dispatch(batch0, **SHARD_PROBE),
                        refs["probe"], "probe"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    a4.merge_backend = "ici"
    for d, want, what in pending:
        got = d.get()
        require_same(got, tuple(x[:64] for x in want) if what != "probe"
                     else want, f"dispatched under sync debug: {what}")
    counts = read_launches()
    peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in devs]

    # the kernels against their plain twins on every card, on this path's
    # inputs: a shard's bit products and dead rows (approx_topk), the
    # re-rank's calls (code_hamming), and a base on the card (l2_topk)
    rows = a4.shard_rows
    checked = []
    for d in devs:
        s = next(s for s in range(4) if a4._slot_device(s) == d)
        qbits = a4._query_bits(a4._queries(batch0), d)[0]
        dots = hs._bit_dots(qbits, a4._shard(a4.bits, s))
        dead = a4._dead_rows(s, a4._shard(a4.tombs, s), a4.n, 4)
        w, r = reduction_output_size(rows, SHARD_L)
        popc = a4._shard(a4.popc, s)
        require(torch.equal(partial_reduce(dots, w, r, 0, popc, -2, dead),
                            partial_reduce_plain(dots, w, r, 0, popc, -2,
                                                 dead)),
                f"approx_topk on {d}")
        pc, qc, ids = hamming_calls[s]
        want = code_hamming_plain(pc, qc, ids)
        for path in (code_hamming_gather, code_hamming_sweep):
            require(torch.equal(path(pc, qc, ids), want),
                    f"code_hamming {path.__name__} on {d}")
        gen = torch.Generator(device=d).manual_seed(d.index or 0)
        b = torch.randn((262_144, 128), generator=gen, device=d)
        q = torch.randn((64, 128), generator=gen, device=d)
        err = check_topk(b, q, *l2_topk(b, q, 100), *bruteforce_topk(b, q,
                                                                     100))
        checked.append(f"{d}: approx_topk [{dots.shape[0]}, {rows}] == "
                       f"plain; code_hamming gather, sweep [{ids.shape[0]}, "
                       f"{ids.shape[1]}] of {pc.shape[0]} rows == plain; "
                       f"l2_topk 262144x128, 64 q, K=100: max |err| "
                       f"{err:.3e}")
        del dots, b, q
    del idx, a4, t, hamming_calls
    release_earlier_phases()

    # the facade over the same slots serves phase 14's ids and distances
    sys_ = DistributedEncryptedSystem(slice_cfg(),
                                      os.path.join(work, "multislot_db"),
                                      128, mesh=mesh)
    try:
        t0 = time.perf_counter()
        sys_.build(base, sample=100_000, capacity=SHARD_CAP)
        t_build = time.perf_counter() - t0
        require(len(sys_.index._per_device(sys_.index.bits))
                == len(mesh.slots), "facade state not one tensor a slot")
        sys_.search_batch(batch0, 100)                    # warm-up
        t0 = time.perf_counter()
        res = sys_.search_batches([queries[s:s + 64]
                                   for s in range(0, Q_SLICE, 64)], 100)
        wall = time.perf_counter() - t0
    finally:
        sys_.close()
    served = tuple(np.concatenate([r[i] for r in res]) for i in (0, 1))
    require_same(served, refs["facade"], "facade over the slots vs phase 14")
    del sys_
    release_earlier_phases()
    log(f"phase 17 sharded index and facade over slots {list(mesh.slots)}: "
        f"{len(devs)} distinct card(s) {[str(d) for d in devs]}, peer "
        f"access {peer or 'n/a (one card)'}; gather for the merge on the "
        f"first card: peer copies of the shards' blocks")
    log(f"  every scan route of the {Q_SLICE} q at L={SHARD_L} (unpacked, "
        f"packed x approx off, on x merge on the first card, on the host) "
        f"and the probe route with the re-rank == the one-slot mesh's; "
        f"one dispatch of each step under set_sync_debug_mode('error'): no "
        f"host sync before get(); the facade served phase 14's ids and "
        f"distances ({Q_SLICE / wall:.1f} q/s, build {t_build:.1f} s)")
    log("  build s: " + ", ".join(f"{lay[la]} {v:.2f}"
                                  for la, v in secs.items())
        + "; device ms per batch of 64 of the default (approximate) route "
        "(CUDA events on every card, the longest span; query upload, device "
        "encode, per-shard scan, gather, merge, pinned copy): " + "; ".join(
            f"{lay[la]} {ms[la, 'ici']:.3f} (host merge "
            f"{ms[la, 'host']:.3f})" for la in lay)
        + f"; probe route with the re-rank {probe_ms:.3f}")
    log("  peak device memory GiB per card: " + ", ".join(
        f"{d} {p:.2f}" for d, p in zip(devs, peaks))
        + f"; kernel launches on this path {counts}")
    for line in checked:
        log(f"  {line}")
    return counts


@dataclasses.dataclass(frozen=True)
class Point:
    """One of the JAX package's two largest served points, at full scale
    through ``ForwardSecureANNSystem``: bench.py's scan profile (f16
    payloads, host encode, batch 64, 1,024 queries of the seed-42
    ``lsh_hard_corpus``) at another width, code width, L and margin."""

    phase: int
    name: str
    n: int
    d: int
    m: int               # projections a group: 24 groups x m x 2 bits
    limit: int           # rerank_limit, the decrypt budget L
    margin: int          # adaptive_decrypt_margin
    recall10: float      # gate: recall@10 at least this, ratio@100 <= 1.01
    corpus_fp: str       # fingerprint(base, queries)
    sample_fp: str       # JAX's r and omega from the corpus's sample

    @property
    def code_bits(self) -> int:
        return 24 * self.m * 2


# sample_fp: sha1 (first 12 hex digits) of r and omega [24, m] of the bank
# the JAX package builds from the point's sample (the first 100,000 rows of
# its corpus, f16 round trip; its coding module's build_bank_from_sample,
# JAX 0.9.0 on the CPU of an AVX-512 host), taken on the corpus whose
# fingerprint is corpus_fp; the port's bank equalled it there bit for bit.
# The 960-d point is bench_results/bench_r5_gist960d.json's operating_point
# (m 128: 6,144-bit codes, L 4,000, margin 72); the deep one bench.py at
# BENCH_N=10000000 BENCH_D=96 (m 64: 3,072 bits, L 2,000, margin 40).
WIDE = Point(18, "wide", 1_000_000, 960, 128, 4000, 72, 0.95,
             "8071bc7f0af6", "e47ac591e3b0")
DEEP = Point(19, "deep", 10_000_000, 96, 64, 2000, 40, 0.98,
             "332dd4d5e388", "c61d430cb0e0")


def point_cfg(pt: Point, **runtime):
    return slice_cfg(m=pt.m, rerank_limit=pt.limit,
                     adaptive_decrypt_margin=pt.margin, **runtime)


def mem_total_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024 / 2 ** 30
    return float("nan")


def serve_point(dev, pt: Point, work: str) -> dict:
    """Phases 18 and 19 (unpacked): ``pt``'s corpus built through the facade
    in the layout ``scan_packed="auto"`` picks, the 1,024 queries served
    with the point's gates, the served route's ``approx_topk`` launches and
    the share of the exact top-L it keeps, the kernel against its plain
    twin on the first batch's products, and that batch's exact route
    against the native host scan.  Returns what the phase goes on with."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.io import groundtruth, synthetic
    from fspann_tpu_torch.ops import approx_topk as at
    from fspann_tpu_torch.ops import hamming_scan as hs
    from fspann_tpu_torch.ops import native_scan

    label = f"phase {pt.phase}"
    stale, left = release_earlier_phases()
    t_phase = time.perf_counter()
    base, queries = synthetic.lsh_hard_corpus(pt.n, pt.d, Q_SLICE, seed=42)
    t_corpus = time.perf_counter() - t_phase
    corpus = fingerprint(base, queries)
    require(corpus == pt.corpus_fp, f"{label}: the corpus differs from the "
            f"one the sample bank's fingerprint was taken on: {corpus}")
    db = os.path.join(work, pt.name)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                   # counts from here are the path's
    sys_ = ForwardSecureANNSystem(point_cfg(pt), db, pt.d, query_batch=64,
                                  device=dev)
    t0 = time.perf_counter()
    sys_.index_stream(base, batch_size=100_000)
    t_insert = time.perf_counter() - t0
    t0 = time.perf_counter()
    sys_.finalize_for_search()
    t_final = time.perf_counter() - t0
    idx = sys_.index
    st, bank, n = idx._scan_state, idx.bank, idx._scan_rows
    stats = fingerprint(bank.r, bank.omega)
    peak_build = torch.cuda.max_memory_allocated()
    log(f"{label} {pt.name} point {pt.n}x{pt.d} hard, seed 42, "
        f"{pt.code_bits}-bit codes (24 groups x m {pt.m} x 2), L={pt.limit}, "
        f"margin {pt.margin}, f16, host encode, batch 64: corpus "
        f"{t_corpus:.1f} s (fingerprint {corpus}); earlier phases held "
        f"{stale / 2**30:.2f} GiB until the cycle collector ran, "
        f"{left / 2**30:.2f} GiB after; host MemTotal "
        f"{mem_total_gib():.1f} GiB")
    log(f"  build {t_insert + t_final:.1f} s (insert {t_insert:.1f} + "
        f"finalize {t_final:.1f}: "
        f"{ {k: round(v, 2) for k, v in idx.finalize_sec.items()} }); r and "
        f"omega {stats}, the JAX package's from this sample {pt.sample_fp}; "
        f"peak device memory {peak_build / 2**30:.2f} GiB (build)")
    require(stats == pt.sample_fp, f"{label}: the bank drawn from the sample "
            "differs from the JAX package's")
    require(isinstance(st, hs.ScanState), f"{label}: scan_packed='auto' "
            f"packed {type(st).__name__}, the unpacked bits fit the budget")
    t0 = time.perf_counter()
    gtm = groundtruth.precompute(base, queries, k=100, backend="kernel",
                                 device=dev)
    torch.cuda.synchronize()
    t_gt = time.perf_counter() - t0
    log(f"  GT (kernel) {t_gt:.2f} s")
    sv = serve_gated(sys_, label, queries, gtm, base, pt.recall10)
    counts = sv["counts"]
    # route_batch's branch, from the budget it cached at the warm-up
    flat_bytes, budget = 64 * n * 12, idx._scan_flat_budget()
    flat = flat_bytes <= budget
    per_batch = scan_launches(n, pt.limit, None if flat else 1 << 19)
    log(f"  scan state {tuple(st.bits.shape)} int8 on {st.bits.device}, "
        f"{st.bits.numel() / 1e9:.2f} GB (unpacked: scan_packed='auto' keeps "
        f"the bits under 60% of the free memory); route_batch's branch: "
        f"{'flat scan' if flat else 'chunked scan'} ([64, {n}] scratch "
        f"{flat_bytes / 2**30:.2f} GiB against a budget of half the free "
        f"memory, {budget / 2**30:.2f} GiB), {per_batch} approx_topk "
        f"launch(es) a batch")
    require(counts["approx_topk"] == (1 + Q_SLICE // 64) * per_batch,
            f"{label}: {counts['approx_topk']} approx_topk launches for the "
            f"warm-up and {Q_SLICE // 64} served batches")

    # the served route: its launches, and the share of the exact top-L
    # (the same scan with approx=False) that it keeps
    sh = served_share(idx, label, queries, per_batch)
    share, exact = sh["share"], sh["exact"]
    batches = [queries[s:s + 64] for s in range(0, Q_SLICE, 64)]

    # the kernel against its plain twin on the first batch's products
    cb, rt = idx.cfg.paper.code_bits, idx.cfg.runtime
    qc0, qk0 = idx.encode_queries(batches[0])
    qbits = torch.from_numpy(hs.unpack_bits_numpy(qc0, cb)).to(dev)
    w, r = at.reduction_output_size(n, pt.limit)
    dots = hs._bit_dots(qbits, st.bits)
    epi = dict(popc=st.popc, scale=-2, dead=idx._tombstones_scan())
    bins = at.partial_reduce(dots, w, r, 0, **epi)
    plain = at.partial_reduce_plain(dots, w, r, 0, **epi)
    require(torch.equal(bins, plain), f"{label}: approx_topk bins differ "
            "from the plain twin's")
    sel, want0 = at.approx_rank_topk(dots, pt.limit, **epi), \
        at._smallest(plain, pt.limit)
    for a, b in zip(sel, want0):
        require(torch.equal(a, b), f"{label}: approx_topk selection differs "
                "from the plain twin's")
    del bins, plain, sel, want0
    rec = time_approx(dots, w, r, **epi)
    rec["launches"] = counts["approx_topk"]
    del dots

    # the first batch's exact route against the native host scan
    os.environ["FSPANN_SCAN_THREADS"] = "auto"
    try:
        t0 = time.perf_counter()
        native = native_scan.scan_topl(
            idx._scan_codes, qc0, None, pt.limit,
            anchor=rt.adaptive_decrypt_anchor,
            margin=rt.adaptive_decrypt_margin,
            floor=rt.adaptive_decrypt_floor)
        native_s = time.perf_counter() - t0
    finally:
        del os.environ["FSPANN_SCAN_THREADS"]
    for f in FIELDS:
        require(np.array_equal(getattr(native, f), exact[0][f]),
                f"{label}: the exact route vs the native host scan: {f}")
    served_ms = time_ms(scan_call(idx, batches[0]), reps=5)
    exact_ms = time_ms(scan_call(idx, batches[0], approx=False), reps=5)
    call_ms = time_ms(lambda: idx.route_batch(qc0, qk0), reps=5)
    log(f"  served route: {sh['launches']} approx_topk launches for the "
        f"{len(batches)} batches; share of the exact top-{pt.limit} kept: "
        f"mean {share.mean():.6f} min {share.min():.6f} (gate: mean >= "
        f"{APPROX_SHARE_GATE}); first batch's exact route == the native "
        f"host scan on every field ({native_s:.2f} s at "
        f"{os.cpu_count()} threads)")
    log(f"  approx_topk [64, {n}] -> W={w} bins (r={r}) == plain twin bit "
        f"for bit (bins and selection): " + approx_line(rec))
    log(f"  scan of one batch of 64 on inputs on the card: {served_ms:.3f} "
        f"ms served (approximate), {exact_ms:.3f} ms with approx=False (CUDA "
        f"events); route_batch from host codes: {call_ms:.3f} ms")
    codes = idx._scan_codes
    sys_.shutdown()
    del sys_, idx, st
    release_earlier_phases()

    # the L2 top-k at the ground truth's shape, on an otherwise empty card
    l2 = check_and_time_topk(torch.from_numpy(base).to(dev),
                             torch.from_numpy(queries).to(dev), 100,
                             f"  {label}", reps=2)
    l2["launches"] = counts["l2_topk"]
    torch.cuda.empty_cache()
    log(f"  {label} wall {time.perf_counter() - t_phase:.1f} s so far")
    return {"db": db, "base": base, "queries": queries, "gtm": gtm,
            "codes": codes, "exact": exact, "peak_serve": sv["peak"],
            "counts": counts, "approx": rec, "l2": l2, "t_phase": t_phase}


def phase_wide(dev, work) -> tuple[dict, dict]:
    """Phase 18: the 960-d point (6,144-bit codes, L 4,000)."""
    p = serve_point(dev, WIDE, work)
    shutil.rmtree(p["db"], ignore_errors=True)
    return p["counts"], {"l2": p["l2"], "approx": p["approx"]}


def phase_deep_packed(dev, pt: Point, p: dict) -> dict:
    """Phase 19, packed: the deep point's store restored into
    ``scan_packed="on"`` at capacity ``n + 65,536`` and served as
    ``serve_packed`` holds it; then one ``insert_live`` of 16,384 rows in
    place, found by a self search.  Returns the path's kernel counts: the
    served pass's and the insert's with its self search."""
    from fspann_tpu_torch.io import synthetic

    label = f"phase {pt.phase}"
    cap = pt.n + 65_536
    sys_, served = serve_packed(
        dev, label, point_cfg(pt, scan_packed="on", scan_capacity_rows=cap),
        p["db"], pt.d, pt.n, p["codes"], p["base"], p["queries"], p["gtm"],
        pt.recall10, p)
    idx = sys_.index

    extra, _ = synthetic.lsh_hard_corpus(16_384, pt.d, 1, seed=43)
    new_ids = pt.n + np.arange(len(extra), dtype=np.int64)
    ptr = idx._scan_state.words.data_ptr()
    reset_launches()                   # the insert path's own counts
    t0 = time.perf_counter()
    sys_.insert_live(new_ids, extra)
    torch.cuda.synchronize()
    insert_ms = (time.perf_counter() - t0) * 1e3
    require(idx._scan_state.words.data_ptr() == ptr
            and idx._scan_rows == cap, f"{label}: insert_live moved the words")
    pick = np.random.default_rng(5).choice(len(extra), 64, replace=False)
    found = serve(sys_, extra[pick], k=10)[0]
    inserted = read_launches()
    require((found[:, 0] == new_ids[pick]).all(), f"{label}: appended rows "
            "not first in their own search")
    sys_.shutdown()
    log(f"  packed: insert_live of {len(extra)} rows in place "
        f"{insert_ms:.1f} ms (words storage kept), 64 of them found first "
        f"by their own search; kernel launches of the insert and its search "
        f"{inserted}")
    return {k: v + inserted[k] for k, v in served.items()}


def phase_deep(dev, work) -> tuple[dict, dict]:
    """Phase 19: the 10M x 96 point, unpacked then packed."""
    p = serve_point(dev, DEEP, work)
    packed = phase_deep_packed(dev, DEEP, p)
    p["approx"]["packed_launches"] = packed["approx_topk"]
    shutil.rmtree(p["db"], ignore_errors=True)
    log(f"  phase {DEEP.phase} wall {time.perf_counter() - p['t_phase']:.1f}"
        " s")
    counts = {k: v + packed[k] for k, v in p["counts"].items()}
    return counts, {"l2": p["l2"], "approx": p["approx"]}


# (script, the line its gate prints); a recall gate is the example's own
EXAMPLES = [("torch_plaintext_ann.py", "recall@10: "),
            ("torch_encrypted_e2e.py", "recall@10: "),
            ("torch_cpu_only_serving.py", "recall@10: "),
            ("torch_sharded_serving.py", "recall@10: "),
            ("torch_mesh_serving.py", "mesh lifecycle OK")]


def phase_examples() -> None:
    """Phase 15: every example on the card, started together."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    t0 = time.perf_counter()
    try:
        for script, gate in EXAMPLES:
            procs.append((script, gate, subprocess.Popen(
                [sys.executable, os.path.join(here, "examples", script)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env)))
        for script, gate, proc in procs:
            out, err = proc.communicate(timeout=600)
            took = time.perf_counter() - t0
            lines = [ln for ln in out.splitlines() if ln.startswith(gate)]
            require(proc.returncode == 0 and lines,
                    f"phase 15 {script}: rc {proc.returncode}\n{out}\n{err}")
            log(f"phase 15 {script}: exit 0 after {took:.1f} s, "
                f"{lines[-1]}")
    finally:
        for _script, _gate, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    card = gpu_line()
    log(f"gpu: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"host cpu: {cpu_model()}, {os.cpu_count()} cores")

    from fspann_tpu_torch import _build
    from fspann_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase 2 build {time.perf_counter() - t0:.1f} s, in parallel "
        f"({ {k: round(v, 1) for k, v in _build.build_seconds.items()} })")
    for lib in sorted(_build.build_logs):
        for line in _build.build_logs[lib].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {lib}: {line.strip()}")

    work = tempfile.mkdtemp(prefix="fspann_smoke_")
    try:
        phase_topk(dev)
        unpacked_ms = phase_scan(dev)
        t0 = time.perf_counter()
        base, queries = synthetic.lsh_hard_corpus(N_SLICE, 128, Q_SLICE,
                                                  seed=42)
        log(f"phase 5 corpus {N_SLICE}x128 hard, seed 42: "
            f"{time.perf_counter() - t0:.1f} s")
        scan_counts, ref, rec, p5 = phase_slice(dev, base, queries, work)
        approx_counts, approx_rec = phase_approx(dev, queries, p5)
        ch_rec = phase_code_hamming(dev)
        phase_probe_equal(dev, base, queries)
        probe_counts = phase_probe_slice(dev, base, queries,
                                         profile="--profile" in sys.argv[1:])
        phase_packed(dev, unpacked_ms)
        life_counts, cuda_route = phase_lifecycle(dev, work, base, queries,
                                                  p5)
        phase_native(work, queries, cuda_route)
        cli_counts = phase_cli(base, queries, work)
        shard_counts, p13 = phase_sharded(dev, base, queries, work, p5)
        mesh_counts, p14 = phase_distributed(dev, base, queries, work, p5,
                                             ref, p13)
        multi_counts = phase_multislot(base, queries, work, {
            **p13, "facade": p14, "bank": p5["bank"]})
        del base, queries, ref, p5, p13, p14
        wide_counts, p18 = phase_wide(dev, work)
        deep_counts, p19 = phase_deep(dev, work)
        release_earlier_phases()
        phase_examples()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    paths = (scan_counts, approx_counts, probe_counts, life_counts,
             cli_counts, shard_counts, mesh_counts, multi_counts,
             wide_counts, deep_counts)
    l2_launches = sum(c["l2_topk"] for c in paths)
    points = {f"{pt.n}x{pt.d}": p for pt, p in ((WIDE, p18), (DEEP, p19))}
    require(shard_counts["code_hamming"] > 0, "the sharded probe route did "
            "not run code_hamming")
    require(shard_counts["approx_topk"] > 0, "the sharded approx scan did "
            "not run approx_topk")
    require(multi_counts["approx_topk"] > 0
            and multi_counts["code_hamming"] > 0, "phase 17 did not run "
            "approx_topk and code_hamming")
    require(deep_counts["packed_dots"] > 0, "phase 19's packed route did "
            "not run packed_dots")

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "l2_topk", "route": "cuda",
        "source": "fspann_tpu_torch/csrc/l2_topk.cu",
        "replaces": "fspann_tpu/ops/pallas_topk.py:106",
        "launches": l2_launches,
        **rec, "points": {k: p["l2"] for k, p in points.items()}}, {
        "name": "code_hamming", "route": "cuda",
        "source": "fspann_tpu_torch/csrc/code_hamming.cu",
        "replaces": "fspann_tpu/ops/routing.py:281",
        "launches": sum(c["code_hamming"] for c in paths),
        **ch_rec}, {
        "name": "approx_topk", "route": "cuda",
        "source": "fspann_tpu_torch/csrc/approx_topk.cu",
        "replaces": "fspann_tpu/ops/hamming_scan.py:212",
        "launches": sum(c["approx_topk"] for c in paths),
        "tail_launches": sum(c["approx_topk_tail"] for c in paths),
        **approx_rec,
        "points": {k: p["approx"] for k, p in points.items()}}, {
        "name": "packed_dots", "route": "cuda",
        "source": "fspann_tpu_torch/csrc/packed_dots.cu",
        "replaces": "fspann_tpu/ops/hamming_scan.py:244",
        "launches": sum(c["packed_dots"] for c in paths)}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
