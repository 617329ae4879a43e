"""Full mesh-serving lifecycle on the PyTorch port: 8 shards on one device.

Demonstrates ``DistributedEncryptedSystem`` (``examples/mesh_serving.py``
on ``fspann_tpu_torch``): streaming encrypted build, scan queries with the
merge on the device, live insertion, deletion/undelete, forced key rotation
with partial migration, storage compaction, and checkpoint/restore.  The
8 shards share one device slot here (``make_mesh(8, device=device)``): row ranges
of one resident tensor on the card (or on the CPU with ``--device cpu``);
``make_mesh(8)`` would spread them over the visible cards.

Run:  python examples/torch_mesh_serving.py [--device cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fspann_tpu_torch.config import SystemConfig, PaperConfig, RuntimeConfig
from fspann_tpu_torch.parallel.serving import DistributedEncryptedSystem
from fspann_tpu_torch.parallel.sharded import make_mesh


def main(device="cuda"):
    rng = np.random.default_rng(7)
    n, d, k = 20_000, 32, 10
    centers = rng.normal(size=(32, d)).astype(np.float32) * 6
    base = centers[rng.integers(0, 32, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 32, 16)] + \
        rng.normal(size=(16, d)).astype(np.float32)

    cfg = SystemConfig(
        paper=PaperConfig(m=12, lam=2, divisions=2, tables=4, seed=13),
        runtime=RuntimeConfig(refinement_limit=1024,
                              max_global_candidates=1024,
                              block_size=64, routing_mode="scan"),
    ).validate()

    work = tempfile.mkdtemp(prefix="fspann_mesh_")
    try:
        sys_ = DistributedEncryptedSystem(cfg, work, d,
                                          mesh=make_mesh(8, device=device))
        mesh = sys_.mesh
        print(f"mesh: {sys_.ndev} shards over {len(mesh.slots)} slot(s) on "
              f"{', '.join(map(str, mesh.devices))}")

        # 1. streaming encrypted build (corpus never materialized)
        total = sys_.index_stream(
            (base[i:i + 4_000] for i in range(0, n, 4_000)),
            n_total=n, capacity=n + 4_096)
        print(f"streamed build: {total} rows, "
              f"{sys_.size_bytes() / 1e6:.1f} MB ciphertext across "
              f"{sys_.store.num_shards} shard arenas")

        # 2. query (per-shard scan + merge + host decrypt/refine)
        ids, dist = sys_.search_batch(queries, k)
        d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
        true_ids = np.argsort(d2, axis=1)[:, :k]
        hits = sum(len(set(ids[i].tolist()) & set(true_ids[i].tolist()))
                   for i in range(len(queries)))
        print(f"recall@{k}: {hits / ids.size:.4f}")

        # 3. live insert — searchable immediately, no rebuild
        def q16(row):
            return np.broadcast_to(row, (16, d)).copy()

        new = (np.full((64, d), 40.0) + rng.normal(size=(64, d))).astype(
            np.float32)
        new_ids = sys_.insert_live(new)
        got, _ = sys_.search_batch(q16(np.full(d, 40.0, np.float32)), k)
        assert set(got[0].tolist()) <= set(new_ids.tolist())
        print(f"live insert: {len(new_ids)} rows, immediately served")

        # 4. delete / undelete (the device mask is written in place)
        victim = int(true_ids[0, 0])
        sys_.delete([victim])
        ids_d, _ = sys_.search_batch(q16(queries[0]), k)
        assert victim not in ids_d[0].tolist()
        restored = sys_.undelete([victim])
        print(f"delete/undelete: victim {victim} removed then restored "
              f"{restored}")

        # 5. forced rotation; migrate HALF now (the rest is the background
        # daemon's job) — routing state untouched either way
        v0 = sys_.km.current_version
        rep = sys_.rotate_and_migrate(np.arange(0, n, 2))
        ids_r, _ = sys_.search_batch(queries, k)
        print(f"rotation v{v0}->v{sys_.km.current_version}: "
              f"{rep.reencrypted} migrated, remaining "
              f"{sys_.migration_remaining(v0)}")

        # 6. compaction reclaims superseded ciphertexts
        comp = sys_.compact_storage()
        print(f"compaction freed {comp['bytes_freed'] / 1e6:.1f} MB")

        # 7. checkpoint + restore (codes-only, no decrypt pass)
        sys_.save_index()
        sys_.close()
        back = DistributedEncryptedSystem(cfg, work, d,
                                          mesh=make_mesh(8, device=device))
        assert back.restore_index() == n + 64
        ids_b, _ = back.search_batch(queries, k)
        print(f"restore: {back.n} rows, query results "
              f"{'match' if np.array_equal(ids_b[1:], ids_r[1:]) else 'differ'}")
        back.close()
        print("mesh lifecycle OK")
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    main(device=p.parse_args().device)
