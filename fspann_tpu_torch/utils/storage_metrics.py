"""Storage metrics: cached on-disk size snapshots.

Reference counterpart: ``common/StorageMetrics.java`` (:24-70) — 5s-TTL
cached dir-size snapshots (total / metadata / points), plus re-encryption
before/after storage snapshots (used by SelectiveReencCoordinator).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass


def dir_size(path: str) -> int:
    """Recursive byte size (reference PathStorageSizer)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


@dataclass
class StorageSnapshot:
    total_bytes: int
    metadata_bytes: int
    points_bytes: int
    taken_at: float


class StorageMetrics:
    TTL_S = 5.0   # reference StorageMetrics 5s cache

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self._cached: StorageSnapshot | None = None

    def snapshot(self, force: bool = False) -> StorageSnapshot:
        now = time.monotonic()
        if (not force and self._cached is not None
                and now - self._cached.taken_at < self.TTL_S):
            return self._cached
        points = dir_size(os.path.join(self.base_dir, "points"))
        meta_path = os.path.join(self.base_dir, "meta.log")
        meta = os.path.getsize(meta_path) if os.path.exists(meta_path) else 0
        self._cached = StorageSnapshot(
            total_bytes=dir_size(self.base_dir),
            metadata_bytes=meta, points_bytes=points, taken_at=now)
        return self._cached

    def reencryption_delta(self, before: StorageSnapshot) -> dict:
        after = self.snapshot(force=True)
        return {
            "bytes_before": before.total_bytes,
            "bytes_after": after.total_bytes,
            "bytes_delta": after.total_bytes - before.total_bytes,
        }
