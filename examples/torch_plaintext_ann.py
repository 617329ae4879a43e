"""End-to-end plaintext ANN slice through the PyTorch port's public API.

Builds the LSH bank from a sample, encodes a corpus on the device, builds
partitions, routes queries, refines, and reports recall@10 against exact
brute force: ``examples/plaintext_ann.py`` on ``fspann_tpu_torch``.

Usage: python examples/torch_plaintext_ann.py [n] [d] [q] [--device cpu]
(default device: the CUDA card)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from fspann_tpu_torch import resolve_device
from fspann_tpu_torch.config import SystemConfig
from fspann_tpu_torch.ops import coding, partition, refine, routing


def main(n=20_000, d=64, q=64, k=10, seed=13, device="cuda"):
    dev = resolve_device(device)
    cfg = SystemConfig()
    pp, rt = cfg.paper, cfg.runtime
    rng = np.random.default_rng(seed)
    # clustered corpus so LSH has structure to find
    centers = rng.normal(size=(64, d)).astype(np.float32) * 6
    assign = rng.integers(0, 64, n)
    base = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 64, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    t0 = time.perf_counter()
    bank = coding.bank_to(coding.build_bank_from_sample(
        base[:2000], pp.m, pp.lam, pp.tables, pp.divisions, pp.seed), dev)
    codes, keys = coding.encode(torch.from_numpy(base).to(dev), bank)
    table = partition.build_partitions(keys.T.contiguous(),
                                       codes.transpose(0, 1).contiguous(),
                                       rt.block_size)
    t_build = time.perf_counter() - t0

    qt = torch.from_numpy(queries).to(dev)
    qc, qk = coding.encode(qt, bank)
    tomb = torch.zeros(n, dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    routed = routing.route(table, qc, qk, tomb, rt.effective_probes(),
                           rt.refinement_limit)
    cand_ids = routed.ids.cpu().numpy()
    # plaintext gather (in the encrypted system the host crypto layer does this)
    cand_vecs = base[np.maximum(cand_ids, 0)]
    valid = cand_ids >= 0
    res = refine.refine(qt, torch.from_numpy(cand_vecs).to(dev),
                        torch.from_numpy(cand_ids).to(dev),
                        torch.from_numpy(valid).to(dev), k)
    got = res.ids.cpu().numpy()
    t_query = time.perf_counter() - t0

    gt_ids, _ = refine.bruteforce_topk(base, qt, k)
    gt_ids = gt_ids.cpu().numpy()
    hits = sum(len(set(got[i].tolist()) & set(gt_ids[i].tolist()))
               for i in range(q))
    recall = hits / (q * k)
    mean_cands = float(routed.n_unique.float().mean())
    print(f"n={n} d={d} q={q} k={k} device={dev}")
    print(f"build: {t_build:.2f}s  query(total): {t_query:.2f}s "
          f"({q / t_query:.1f} q/s)")
    print(f"mean unique candidates: {mean_cands:.0f} "
          f"({100 * mean_cands / n:.1f}% of corpus)")
    print(f"recall@{k}: {recall:.4f}")
    return recall


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*", type=int, help="n d q")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    r = main(*a.sizes[:3], device=a.device)
    sys.exit(0 if r > 0.8 else 1)
