"""CPU-only encrypted serving through the PyTorch port: no card anywhere.

Stage A goes through the native packed-word kernel
(``csrc/native/hamming_topl.c``; picked by ``runtime.scan_native="auto"``
when the index serves from the CPU), and stages B/C are the host AES + BLAS
paths that never needed a device.  Results are the same as the card's
(``tests/test_torch_native_scan.py``).  This example asks for the CPU
itself (``device="cpu"``), so it runs the same on a host with a card;
``--device`` names where the exact ground truth is computed.

Usage: python examples/torch_cpu_only_serving.py [n] [d] [q] [--device cpu]
"""

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fspann_tpu_torch.api.system import ForwardSecureANNSystem
from fspann_tpu_torch.config import SystemConfig
from fspann_tpu_torch.io import groundtruth
from fspann_tpu_torch.ops import native_scan


def main(n=20_000, d=32, q=32, device="cuda"):
    print(f"native kernel available: {native_scan.available()}  "
          f"serving device: cpu")
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(64, d)).astype(np.float32) * 6
    base = centers[rng.integers(0, 64, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 64, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    cfg = SystemConfig()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime,
        routing_mode="scan",           # global exact code ranking
        scan_native="auto",            # native kernel on the CPU
        refinement_limit=2000,
        adaptive_decrypt_margin=40,    # per-query decrypt budget
        adaptive_decrypt_anchor=100)).validate()

    work = tempfile.mkdtemp(prefix="fspann_cpu_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, work + "/db", d, query_batch=16,
                                      device="cpu")
        t0 = time.perf_counter()
        sys_.index_stream(base, batch_size=5000)
        sys_.finalize_for_search()
        # native-only serving builds no bit matrix: the packed codes
        # (n x bits/8 bytes) are the whole routing state
        if sys_.index._scan_state is None and \
                sys_.index._scan_codes is not None:
            state = (f"packed codes only "
                     f"({sys_.index._scan_codes.nbytes/1e6:.1f} MB)")
        else:
            state = "torch bit matrix — native kernel unavailable"
        print(f"indexed {n} pts in {time.perf_counter()-t0:.1f}s; scan "
              f"state = {state}")

        gtm = groundtruth.precompute(base, queries, k=100, device=device)
        t0 = time.perf_counter()
        agg = sys_.run_queries(queries, gtm, base)
        dt = time.perf_counter() - t0
        print(f"queries: {agg.paper_line()}  wall {dt:.2f}s "
              f"({q/dt:.1f} q/s)")
        print(f"recall@10: {agg.recall_at_k[10]:.4f}")
        assert agg.recall_at_k[10] > 0.9
        sys_.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*", type=int, help="n d q")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(*a.sizes[:3], device=a.device)
