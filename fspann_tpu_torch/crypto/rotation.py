"""Key lifecycle: rotation policy, usage tracking, selective re-encryption.

Reference counterparts:
* ``KeyRotationServiceImpl`` (keymanagement/KeyRotationServiceImpl.java) —
  rotateIfNeeded on ops/age thresholds (:66-74), rotateKeyOnly (:292-298),
  reEncryptAll (:98-146), reencryptTouched (:215-289), finalizeRotation
  deletes keys < current-1 (:314-334), activateVersion pins a version for
  query-only restore (:173-193), migrationRemaining (:433-446).
* ``KeyUsageTracker`` (KeyUsageTracker.java) — version↔vector binding counts;
  ``isSafeToDelete`` = no bound vectors (:72-82).  Here the binding counts
  live in the metadata log (count_with_version), so the tracker is a thin
  view instead of a second bookkeeping structure that can drift.
* ``ReencryptionTracker`` (crypto/ReencryptionTracker.java) — touched-id set
  drained by the end-of-run selective pass.
* ``BackgroundReencryptionScheduler`` (keymanagement/...) — daemon that
  migrates sampled stale points between queries.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..store.point_store import PointStore, ReencryptReport
from .keys import KeyManager


class RotationRefused(RuntimeError):
    """Forced rotation attempted against a pinned/frozen rotation service."""


@dataclass
class RotationPolicy:
    """Reference KeyRotationPolicy.java: {maxOperations, maxIntervalMillis}."""

    max_operations: int = 1_000_000_000
    max_interval_ms: float = float("inf")


class ReencryptionTracker:
    """Thread-safe touched-id accumulator (reference ReencryptionTracker.java).

    Accumulates numpy id arrays and dedups lazily: the per-batch ``record``
    on the serving hot path is an O(1) append (a Python-set update cost
    ~1 ms per query batch at serving rates), with ``np.unique`` paid only
    on reads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._parts: list = []
        self._compacted = False   # _parts is one sorted-unique array

    def record(self, ids) -> None:
        ids = np.asarray(ids, np.int64)
        if not len(ids):
            return
        with self._lock:
            self._parts.append(ids)
            self._compacted = False

    def _compact_locked(self) -> "np.ndarray":
        """Collapse to ONE sorted-unique array (np.unique sorts — the
        sorted-drain contract) and remember it, so repeated reads don't
        re-pay np.unique over an already-compacted set."""
        if self._parts and not self._compacted:
            self._parts = [np.unique(np.concatenate(self._parts))
                           if len(self._parts) > 1
                           else np.unique(self._parts[0])]
            self._compacted = True
        return self._parts[0] if self._parts else np.empty(0, np.int64)

    def unique_count(self) -> int:
        with self._lock:
            return int(len(self._compact_locked()))

    def drain(self) -> list[int]:
        with self._lock:
            out = self._compact_locked().tolist()
            self._parts = []
            self._compacted = False
            return out


class KeyRotationService:
    """Owns rotation decisions and re-encryption sweeps over a PointStore.

    Invariant preserved from the reference: rotation and re-encryption never
    touch routing state — only ciphertexts, metadata, and the keystore.
    """

    def __init__(self, km: KeyManager, store: PointStore,
                 policy: RotationPolicy | None = None):
        self.km = km
        self.store = store
        self.policy = policy or RotationPolicy()
        self.ops_since_rotation = 0
        self.last_rotation_ms = time.time() * 1e3
        self.pinned_version: int | None = None   # activateVersion
        self.rotation_frozen = False

    # -- policy ----------------------------------------------------------------

    def track_operations(self, n: int = 1) -> None:
        self.ops_since_rotation += n

    def rotate_if_needed(self) -> bool:
        if self.rotation_frozen or self.pinned_version is not None:
            return False
        age = time.time() * 1e3 - self.last_rotation_ms
        if (self.ops_since_rotation >= self.policy.max_operations
                or age >= self.policy.max_interval_ms):
            self.rotate_key_only()
            return True
        return False

    def rotate_key_only(self) -> int:
        """Bump version with NO re-encryption (reference rotateKeyOnly:292-298);
        new writes use the new key, old ciphertexts stay lazily migrated."""
        kv = self.km.rotate()
        self.ops_since_rotation = 0
        self.last_rotation_ms = time.time() * 1e3
        return kv.version

    def force_rotate_now(self) -> int:
        """HARD rotation — but still refused under an explicit pin or
        freeze: a version-pinned restore (query-only mode) must never be
        rotated out from under its pin.  Deliberately stricter than the
        reference's unconditional forceRotateNow
        (KeyRotationServiceImpl.java:302-305); its rotateIfNeeded guard
        (:67) is the semantic being protected."""
        if self.rotation_frozen:
            raise RotationRefused("rotation is frozen")
        if self.pinned_version is not None:
            raise RotationRefused(
                f"key version pinned at {self.pinned_version} "
                "(query-only restore) — refusing forced rotation")
        return self.rotate_key_only()

    # -- re-encryption -----------------------------------------------------------

    def reencrypt_touched(self, ids, target_version: int | None = None
                          ) -> ReencryptReport:
        return self.store.reencrypt_ids(ids, target_version)

    def reencrypt_all(self) -> ReencryptReport:
        return self.store.reencrypt_all(self.km.current_version)

    def migration_remaining(self, version: int) -> int:
        """Live points still on an old version (reference :433-446)."""
        return self.store.meta.count_with_version(version)

    # -- deletion ----------------------------------------------------------------

    def is_safe_to_delete(self, version: int) -> bool:
        return (version < self.km.current_version
                and self.store.meta.count_with_version(version) == 0)

    def finalize_rotation(self) -> list[int]:
        """Securely delete key versions < current-1 with no bound ciphertexts
        (reference finalizeRotation:314-334), retiring their arenas too."""
        dropped = []
        for v in self.km.live_versions():
            if v >= self.km.current_version - 1:
                continue
            if not self.is_safe_to_delete(v):
                continue
            self.store.retire_version(v)
            self.km.delete_version(v)
            dropped.append(v)
        return dropped

    # -- restore ----------------------------------------------------------------

    def activate_version(self, version: int) -> None:
        """Pin a version and disable auto-rotation (query-only restore,
        reference activateVersion:173-193)."""
        self.km.get_version(version)  # validates liveness
        self.pinned_version = version


class BackgroundReencryption:
    """Daemon migrating sampled stale points (reference
    BackgroundReencryptionScheduler.java:60-137): rate-limited, pauses under
    query load, thread-based like the reference's ScheduledExecutorService."""

    def __init__(self, svc: KeyRotationService, interval_s: float = 5.0,
                 batch: int = 2_000, load_shed_qps: float = 50.0,
                 metrics=None):
        self.svc = svc
        self.interval_s = interval_s
        self.batch = batch
        self.load_shed_qps = load_shed_qps
        # QPS window: a locked deque — note_query is called from query
        # threads while _loop reads, so the structure must be mutated under
        # a lock (the reference used a ScheduledExecutorService + atomics)
        self._recent_queries: deque[float] = deque()
        self._qlock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.migrated_total = 0
        self.passes = 0
        self.errors = 0
        self.metrics = metrics   # optional MetricsRegistry

    def note_query(self) -> None:
        now = time.time()
        with self._qlock:
            self._recent_queries.append(now)
            while self._recent_queries and now - self._recent_queries[0] >= 1.0:
                self._recent_queries.popleft()

    def _qps(self) -> float:
        now = time.time()
        with self._qlock:
            while self._recent_queries and now - self._recent_queries[0] >= 1.0:
                self._recent_queries.popleft()
            return float(len(self._recent_queries))

    def run_once(self) -> int:
        """One migration pass: sample stale ids below current version."""
        cur = self.svc.km.current_version
        stale = self.svc.store.meta.stale_ids(cur)
        if not len(stale):
            return 0
        take = min(self.batch, len(stale))
        sample = np.random.default_rng().choice(stale, take, replace=False)
        report = self.svc.reencrypt_touched(sample, cur)
        self.migrated_total += report.reencrypted
        self.passes += 1
        return report.reencrypted

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self._qps() > self.load_shed_qps:
                continue  # shed load while queries are hot
            try:
                self.run_once()
            except Exception:   # noqa: BLE001 — daemon must not die
                # ...but failures must not be invisible either: surface a
                # counter the operator can alarm on
                self.errors += 1
                if self.metrics is not None:
                    self.metrics.count("reencryption.background_errors")

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="fspann-reenc")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
