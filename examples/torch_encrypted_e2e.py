"""Encrypted end-to-end demo through the PyTorch port's public facade.

Index → finalize → encrypted queries (recall/ratio vs exact GT) → forced
rotation + selective re-encryption → query again → restore from disk:
``examples/encrypted_e2e.py`` on ``fspann_tpu_torch``.

Usage: python examples/torch_encrypted_e2e.py [n] [d] [q] [--device cpu]
(default device: the CUDA card)
"""

import argparse
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


def main(n=20_000, d=32, q=32, device="cuda"):
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(64, d)).astype(np.float32) * 6
    base = centers[rng.integers(0, 64, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 64, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    work = tempfile.mkdtemp(prefix="fspann_demo_")
    try:
        sys_ = ForwardSecureANNSystem(SystemConfig(), work + "/db", d,
                                      query_batch=16, device=device)
        t0 = time.perf_counter()
        sys_.index_stream(base, batch_size=5000)
        sys_.finalize_for_search()
        print(f"indexed {n} pts in {time.perf_counter()-t0:.1f}s on "
              f"{sys_.index.device} "
              f"(storage {sys_.store.size_bytes()/1e6:.1f} MB)")

        gtm = groundtruth.precompute(base, queries, k=100, device=device)
        t0 = time.perf_counter()
        agg = sys_.run_queries(queries, gtm, base)
        dt = time.perf_counter() - t0
        print(f"queries: {agg.paper_line()}  wall {dt:.2f}s "
              f"({q/dt:.1f} q/s)")

        rep = sys_.run_selective_reencryption()
        print(f"S-R.E: rotated v{rep['old_version']}→v{rep['new_version']}, "
              f"reencrypted {rep['reencrypted']} touched ids in "
              f"{rep['time_ms']:.0f}ms, {rep['migration_remaining']} remain")

        sys_.profiler.clear_rows()
        agg2 = sys_.run_queries(queries, gtm, base)
        print(f"post-rotation: {agg2.paper_line()}")
        assert abs(agg2.recall_at_k[10] - agg.recall_at_k[10]) < 1e-9, \
            "rotation changed routing!"
        sys_.shutdown()

        sys2 = ForwardSecureANNSystem(SystemConfig(), work + "/db", d,
                                      device=device)
        nres = sys2.restore_index_from_disk()
        res = sys2.search(sys2.create_token(queries[0], 10))
        print(f"restore: {nres} pts; query top-1 id={res[0].id} "
              f"dist={res[0].distance:.3f}")
        sys2.shutdown()
        print(f"recall@10: {agg.recall_at_k[10]:.4f}")
        return agg.recall_at_k[10]
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*", type=int, help="n d q")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    r = main(*a.sizes[:3], device=a.device)
    sys.exit(0 if r > 0.8 else 1)
