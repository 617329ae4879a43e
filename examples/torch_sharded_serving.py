"""Sharded serving demo on the PyTorch port: corpus-sharded routing + merged
top-k.  By default the mesh is one shard on each visible CUDA card
(``make_mesh()``), merged on the first; ``--device`` puts every shard on
one device instead (one shard per visible CUDA card on a card, one on the
CPU).

Usage: python examples/torch_sharded_serving.py [n] [d] [q] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from fspann_tpu_torch.ops import coding, refine
from fspann_tpu_torch.parallel.sharded import ShardedIndex, make_mesh


def main(n=100_000, d=64, q=64, k=10, device=None):
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(256, d)).astype(np.float32) * 6
    base = centers[rng.integers(0, 256, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 256, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    mesh = make_mesh() if device is None else make_mesh(device=device)
    print(f"mesh: {mesh.n_shards} shards over {len(mesh.slots)} slot(s) on "
          f"{', '.join(map(str, mesh.devices))}")
    bank = coding.build_bank_from_sample(base[:2000], m=16, lam=2, tables=4,
                                         divisions=2, seed=13)
    idx = ShardedIndex(mesh, bank)
    t0 = time.perf_counter()
    idx.build(base)
    print(f"sharded build: {time.perf_counter()-t0:.2f}s "
          f"({idx.shard_rows} rows/shard)")

    t0 = time.perf_counter()
    ids, dist = idx.query(queries, probes=4, refinement_limit=2048, k=k)
    t1 = time.perf_counter()
    ids2, _ = idx.query(queries, probes=4, refinement_limit=2048, k=k)
    t2 = time.perf_counter()
    gt_ids, _ = refine.bruteforce_topk(
        base, torch.from_numpy(queries).to(mesh.device), k)
    gt_ids = gt_ids.cpu().numpy()
    ids = np.asarray(ids)
    hits = sum(len(set(ids[i].tolist()) & set(gt_ids[i].tolist()))
               for i in range(q))
    print(f"recall@{k}: {hits/(q*k):.4f}")
    print(f"query: {t1-t0:.2f}s first, {t2-t1:.3f}s second "
          f"({q/(t2-t1):.0f} q/s)")
    return hits / (q * k)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*", type=int, help="n d q")
    p.add_argument("--device", default=None,
                   help="one device for every shard (default: one shard "
                        "on each visible CUDA card)")
    a = p.parse_args()
    r = main(*a.sizes[:3], device=a.device)
    sys.exit(0 if r > 0.8 else 1)
