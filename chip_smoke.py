"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. a CUDA device must be present; print its name and power limit;
  2. build the kernels from the checkout's sources (nvcc for sm_90a, gcc
     for the host AES-GCM library);
  3. the L2 top-k kernel against its plain torch twin at d=128, K=100,
     262,144 base rows x 256 queries;
  4. the Hamming scan on CUDA against the same scan on the CPU: 100k rows
     of 3,072-bit codes, 64-query batch, L=2,000, margin 40 — bit-identical;
  5. the encrypted scan-query slice at bench.py's operating point (1M x 128
     LSH-hard corpus, m=64 → 3,072-bit codes, L=2,000, margin 40, f16
     payloads, host encode, batch 64) through ForwardSecureANNSystem, with
     ground truth from the kernel; recall@10 >= 0.98 and ratio@100 <= 1.01.
The last two lines of standard output are the kernels' JSON record and the
device JSON line.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
N_SLICE = 1_000_000
Q_SLICE = 1024


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


def phase_topk(dev) -> dict:
    from fspann_tpu_torch.ops.l2_topk import l2_topk
    from fspann_tpu_torch.ops.refine import bruteforce_topk

    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.standard_normal((262_144, 128),
                                                dtype=np.float32)).to(dev)
    queries = torch.from_numpy(rng.standard_normal((256, 128),
                                                   dtype=np.float32)).to(dev)
    ids_k, d_k = l2_topk(base, queries, 100)
    ids_p, d_p = bruteforce_topk(base, queries, 100)
    torch.cuda.synchronize()
    err = check_topk(base, queries, ids_k, d_k, ids_p, d_p)
    # turns: plain, kernel, kernel, plain
    p1 = time_ms(lambda: bruteforce_topk(base, queries, 100))
    k1 = time_ms(lambda: l2_topk(base, queries, 100))
    k2 = time_ms(lambda: l2_topk(base, queries, 100))
    p2 = time_ms(lambda: bruteforce_topk(base, queries, 100))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log(f"phase 3 l2_topk 262144x128, 256 q, K=100: max |err| {err:.3e}; "
        f"kernel {ms:.3f} ms (turns {k1:.3f}, {k2:.3f}), plain "
        f"{plain_ms:.3f} ms (turns {p1:.3f}, {p2:.3f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_scan(dev) -> None:
    from fspann_tpu_torch.ops import hamming_scan as hs

    rng = np.random.default_rng(11)
    n, g, w, cb = 100_000, 24, 4, 128           # 24 groups x 128 bits
    codes = rng.integers(0, 1 << 32, (n, g, w), dtype=np.uint64) \
        .astype(np.uint32)
    qcodes = codes[rng.integers(0, n, 64)].copy()
    qcodes[:, :, 0] ^= rng.integers(0, 1 << 32, (64, g), dtype=np.uint64) \
        .astype(np.uint32)                      # near, not equal, queries
    tomb = rng.random(n) < 0.01
    qbits = torch.from_numpy(hs.unpack_bits_numpy(qcodes, cb))
    states = {d: hs.build_scan_state(codes, cb, device=d)
              for d in ("cpu", dev)}
    require(torch.equal(states["cpu"].bits, states[dev].bits.cpu()), "bits")
    require(torch.equal(states["cpu"].popc, states[dev].popc.cpu()), "popc")
    kw = dict(anchor=100, margin=40)
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
        f"40: CUDA == CPU bit for bit (flat and chunked); CUDA flat scan at "
        f"Q=64: {ms:.3f} ms")


def phase_slice(dev, topk_rec: dict) -> None:
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem
    from fspann_tpu_torch.config import SystemConfig
    from fspann_tpu_torch.io import groundtruth, synthetic
    from fspann_tpu_torch.ops.l2_topk import l2_topk
    from fspann_tpu_torch.ops.refine import bruteforce_topk

    t0 = time.perf_counter()
    base, queries = synthetic.lsh_hard_corpus(N_SLICE, 128, Q_SLICE, seed=42)
    log(f"phase 5 corpus {N_SLICE}x128 hard, seed 42: "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg, paper=dataclasses.replace(cfg.paper, tables=8, m=64),
        runtime=dataclasses.replace(
            cfg.runtime, storage_dtype="f16", encode_backend="cpu",
            probe_override=16, block_size=128, refinement_limit=56_000,
            max_global_candidates=56_000, rerank_limit=2000,
            adaptive_decrypt_margin=40, routing_mode="scan")).validate()
    work = tempfile.mkdtemp(prefix="fspann_smoke_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), 128,
                                      query_batch=64)
        torch.cuda.reset_peak_memory_stats()
        l2_topk.launches = 0               # counts from here are the path's
        t0 = time.perf_counter()
        sys_.index_stream(base, batch_size=100_000)
        t_insert = time.perf_counter() - t0
        t0 = time.perf_counter()
        sys_.finalize_for_search()
        t_final = time.perf_counter() - t0
        st = sys_.index._scan_state
        bank = sys_.index.bank
        log(f"  fingerprints: corpus {fingerprint(base, queries)}, bank "
            f"{fingerprint(bank.alpha, bank.r, bank.omega)}, popcounts "
            f"{fingerprint(st.popc.cpu().numpy())}")
        require(st.bits.device.type == torch.device(dev).type, st.bits.device)
        log(f"  build {t_insert + t_final:.1f} s (insert {t_insert:.1f} + "
            f"finalize {t_final:.1f}); scan state {tuple(st.bits.shape)} "
            f"int8 on {st.bits.device}, {st.bits.numel() / 1e9:.2f} GB")
        t0 = time.perf_counter()
        gtm = groundtruth.precompute(base, queries, k=100, backend="kernel")
        torch.cuda.synchronize()
        t_gt = time.perf_counter() - t0
        sys_.run_queries(queries[:64], gtm, base, ks=(10,))   # warm-up
        sys_.profiler.clear_rows()
        t0 = time.perf_counter()
        agg = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
        wall = time.perf_counter() - t0
        launches = l2_topk.launches
        require(launches > 0, "ground truth did not run the l2_topk kernel")
        topk_rec["launches"] = launches
        rows = [r for r in sys_.profiler.rows if r.k == 10]
        nq = len(rows)
        peak = torch.cuda.max_memory_allocated()
        log(f"  GT (kernel) {t_gt:.2f} s; l2_topk launches {launches}")
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
            f"peak device memory {peak / 2**30:.2f} GiB")
        require(r10 >= 0.98, f"recall@10 {r10} < 0.98")
        require(ratio <= 1.01, f"ratio@100 {ratio} > 1.01")
        sys_.shutdown()

        # the kernel against its plain twin at the slice's GT shape
        b = torch.from_numpy(base).to(dev)
        q = torch.from_numpy(queries).to(dev)
        ids_k, d_k = l2_topk(b, q, 100)
        ids_p, d_p = bruteforce_topk(b, q, 100)
        torch.cuda.synchronize()
        err = check_topk(b, q, ids_k, d_k, ids_p, d_p)
        p1 = time_ms(lambda: bruteforce_topk(b, q, 100), reps=2)
        k1 = time_ms(lambda: l2_topk(b, q, 100), reps=2)
        k2 = time_ms(lambda: l2_topk(b, q, 100), reps=2)
        p2 = time_ms(lambda: bruteforce_topk(b, q, 100), reps=2)
        log(f"  l2_topk at {N_SLICE}x128, {Q_SLICE} q, K=100: max |err| "
            f"{err:.3e}; kernel {(k1 + k2) / 2:.3f} ms (turns {k1:.3f}, "
            f"{k2:.3f}), plain {(p1 + p2) / 2:.3f} ms (turns {p1:.3f}, "
            f"{p2:.3f})")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    card = gpu_line()
    log(f"gpu: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"host cpu: {cpu_model()}, {os.cpu_count()} cores")

    from fspann_tpu_torch import _build
    t0 = time.perf_counter()
    _build.cuda_library("l2_topk")
    _build.aes_gcm_library_path()
    log(f"phase 2 build {time.perf_counter() - t0:.1f} s "
        f"({ {k: round(v, 1) for k, v in _build.build_seconds.items()} })")
    for line in _build.build_logs.get("libl2_topk.so", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    rec = phase_topk(dev)
    phase_scan(dev)
    phase_slice(dev, rec)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "l2_topk", "route": "cuda",
        "source": "fspann_tpu_torch/csrc/l2_topk.cu",
        "replaces": "fspann_tpu/ops/pallas_topk.py:106",
        "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
