"""Selective re-encryption coordinator.

Reference counterpart: ``crypto/SelectiveReencCoordinator.java`` (:31-124) —
orchestrates one selective pass: delegate to the rotation service, measure
bytes on disk before/after, bump counters, append a summary row to
``reencrypt_metrics.csv``.
"""

from __future__ import annotations

import csv
import os
import time

from ..utils.metrics import MetricsRegistry
from ..utils.storage_metrics import StorageMetrics
from .rotation import KeyRotationService

_FIELDS = ["timestamp", "target_version", "touched", "reencrypted",
           "skipped_current", "failed", "time_ms", "bytes_before",
           "bytes_after", "bytes_delta", "migration_remaining"]


class SelectiveReencCoordinator:
    def __init__(self, rotation: KeyRotationService,
                 storage: StorageMetrics,
                 metrics: MetricsRegistry | None = None,
                 csv_path: str | None = None):
        self.rotation = rotation
        self.storage = storage
        self.metrics = metrics or MetricsRegistry()
        self.csv_path = csv_path
        self.history: list[dict] = []

    def run_once_with_version(self, target_version: int, ids) -> dict:
        before = self.storage.snapshot(force=True)
        report = self.rotation.reencrypt_touched(ids, target_version)
        after = self.storage.snapshot(force=True)
        remaining = self.rotation.migration_remaining(target_version - 1)
        row = {
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "target_version": target_version,
            "touched": report.touched,
            "reencrypted": report.reencrypted,
            "skipped_current": report.skipped_current,
            "failed": report.failed,
            "time_ms": round(report.time_ms, 2),
            "bytes_before": before.total_bytes,
            "bytes_after": after.total_bytes,
            "bytes_delta": after.total_bytes - before.total_bytes,
            "migration_remaining": remaining,
        }
        self.metrics.count("reenc.passes")
        self.metrics.count("reenc.migrated", report.reencrypted)
        self.metrics.record("reenc.time_ms", report.time_ms)
        self.history.append(row)
        if self.csv_path:
            self._append_csv(row)
        return row

    def _append_csv(self, row: dict) -> None:
        os.makedirs(os.path.dirname(self.csv_path) or ".", exist_ok=True)
        exists = os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=_FIELDS)
            if not exists:
                w.writeheader()
            w.writerow(row)
