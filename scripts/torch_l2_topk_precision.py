"""The port's L2 top-k kernel against a build of it with extra defines.

    python3 scripts/torch_l2_topk_precision.py [--define NAME] [--out FILE]

Needs one CUDA card.  Builds ``fspann_tpu_torch/csrc/l2_topk.cu`` twice:
as shipped (split TF32: q.b = lo.hi + hi.lo + hi.hi) and with ``-DNAME``,
by default ``FSPANN_L2_TOPK_ONE_TF32_PASS`` (hi.hi alone, the control of
the accuracy limit; ``NDEBUG`` drops the kernel's device assert).  At each
shape it prints, for both builds and the plain float32 twin
(``ops/refine.bruteforce_topk``), ``ops/l2_topk.float64_error`` (the
largest |dist^2 - d64^2| / (|q|^2 + |b|^2) over the returned pairs) and the
ids that differ from the plain twin's at distances that are not tied; at
the four shapes of chip_smoke.py it also times both builds in turns
(shipped, variant, variant, shipped; CUDA events).  With the one-pass
control it exits 1 unless ``ops/l2_topk.F32_ERROR_LIMIT`` lies between the
shipped kernel's largest reading and the control's smallest.  The other
shapes are the cuda tests' edges.  ``--out`` also writes the readings as
JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fspann_tpu_torch import _build  # noqa: E402
from fspann_tpu_torch.io import synthetic  # noqa: E402
from fspann_tpu_torch.ops import l2_topk as l2  # noqa: E402
from fspann_tpu_torch.ops import refine  # noqa: E402

RTOL, ATOL = 2e-4, 1e-4     # tests/test_pallas_topk.py
ONE_PASS = "FSPANN_L2_TOPK_ONE_TF32_PASS"


def variant_library(define: str):
    """The kernel built with ``-D<define>``, bound like the shipped one."""
    src = os.path.join(_build.CSRC_DIR, "l2_topk.cu")
    path = _build._build(
        f"libl2_topk_{define.lower()}.so", [src],
        lambda out: [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{define}",
                     "-o", out, src])
    return l2._bind(ctypes.CDLL(path))


def untied_flips(ids, p_ids, p_dists) -> int:
    """Ids that differ from the plain twin's where the plain distances are
    not tied within the tolerance with a neighbour."""
    ids, p_ids, p_d = ids.cpu().numpy(), p_ids.cpu().numpy(), \
        p_dists.cpu().double().numpy()
    gap = np.abs(np.diff(p_d, axis=1)) > ATOL + RTOL * p_d[:, 1:]
    ones = np.ones((p_d.shape[0], 1), bool)
    keep = np.concatenate([ones, gap], 1) & np.concatenate([gap, ones], 1)
    return int(((ids != p_ids) & keep).sum())


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


def shapes():
    """(label, base, queries, k, timed)."""
    rng = np.random.default_rng(7)
    for d in (128, 960):          # chip_smoke.py phase 3
        yield (f"phase 3 262144x{d} 256q",
               rng.standard_normal((262_144, d), dtype=np.float32),
               rng.standard_normal((256, d), dtype=np.float32), 100, True)
    for d, phase in ((128, 5), (960, 18)):
        base, queries = synthetic.lsh_hard_corpus(1_000_000, d, 1024, seed=42)
        yield f"phase {phase} 1Mx{d} hard 1024q", base, queries, 100, True
        del base, queries
    for n, d, q, k in [(700, 12, 1, 1), (5000, 100, 63, 100),
                       (20_001, 960, 65, 128), (130_001, 128, 129, 100),
                       (3001, 13, 64, 10)]:   # the cuda tests' edges
        r = np.random.default_rng(n)
        yield (f"test {n}x{d} {q}q k={k}",
               r.normal(size=(n, d)).astype(np.float32),
               r.normal(size=(q, d)).astype(np.float32), k, False)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--define", default=ONE_PASS,
                    help="macro the variant build defines")
    ap.add_argument("--out", help="also write the readings here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {card}; variant -D{args.define}; limit F32_ERROR_LIMIT = "
          f"{l2.F32_ERROR_LIMIT:g}", flush=True)
    libs = {"shipped": l2._lib(), "variant": variant_library(args.define)}
    rows = []
    for label, base, queries, k, timed in shapes():
        b = torch.from_numpy(base).cuda()
        q = torch.from_numpy(queries).cuda()
        p_ids, p_d = refine.bruteforce_topk(b, q, k)
        row = {"shape": label, "k": k,
               "plain": l2.float64_error(b, q, p_ids, p_d)}
        for name, lib in libs.items():
            l2._LIB = lib
            ids, dists = l2.l2_topk(b, q, k)
            row[name] = l2.float64_error(b, q, ids, dists)
            row[f"{name}_flips"] = untied_flips(ids, p_ids, p_d)
        line = (f"{label}: float64_error shipped {row['shipped']:.3e} "
                f"(untied flips {row['shipped_flips']}), variant "
                f"{row['variant']:.3e} (untied flips {row['variant_flips']}),"
                f" plain float32 {row['plain']:.3e}")
        if timed:
            turns = {"shipped": [], "variant": []}
            for name in ("shipped", "variant", "variant", "shipped"):
                l2._LIB = libs[name]
                turns[name].append(time_ms(lambda: l2.l2_topk(b, q, k)))
            row.update({f"{name}_ms": t for name, t in turns.items()})
            line += "; ms " + ", ".join(
                f"{name} {', '.join(f'{t:.3f}' for t in ts)}"
                for name, ts in turns.items())
        l2._LIB = libs["shipped"]
        rows.append(row)
        print(line, flush=True)
        del b, q, p_ids, p_d
        torch.cuda.empty_cache()
    ok = True
    if args.define == ONE_PASS:
        hi = max(r["shipped"] for r in rows)
        lo = min(r["variant"] for r in rows)
        ok = hi <= l2.F32_ERROR_LIMIT < lo
        print(f"split TF32 at most {hi:.3e}; one TF32 pass at least "
              f"{lo:.3e}; limit {l2.F32_ERROR_LIMIT:g} "
              f"{'between' if ok else 'NOT between'} them", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": card, "define": args.define,
                       "limit": l2.F32_ERROR_LIMIT, "rows": rows}, f,
                      indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
