"""Versioned keystore: ratcheted HMAC-derived session keys + atomic persistence.

Reference counterpart: ``keymanagement/KeyManager.java`` —
``K_v = HMAC-SHA256(K_master, int32_be(v))[:32]`` (KeyManager.java:221-237),
keystore persisted via temp-file + atomic rename (:185-219), retention window
(:35-36), secure wipe on deletion (SecureKeyDeletion.java, best-effort —
Python, like the JVM, cannot guarantee erasure of immutable byte copies).

Deliberate strengthening over the reference: the reference persists ONE
fixed master forever, so a stolen post-rotation keystore re-derives every
"securely deleted" session key — its deletion soundness is purely an API
check.  Here the master is a HASH RATCHET: ``M_{v+1} = HMAC(M_v,
"fspann/ratchet")``, ``K_v = HMAC(M_v, "fspann/session")``, and the
keystore persists only the chain head ``M_b`` for the lowest non-deleted
version ``b``.  Deleting the oldest live version advances the head one
step and wipes the predecessor, so versions below the head are
CRYPTOGRAPHICALLY unrecoverable from a stolen blob (one-wayness of the
chain step), not merely refused.  Deleting a version that is not the
current oldest leaves a hole: it stays derivable-in-principle from the
persisted head until every version below it is also deleted (the API
refuses it either way) — retention deletes oldest-first, so in normal
operation erasure is immediate.  Game G1' (tests/test_forward_security.py)
plays the stolen-keystore adversary against an old arena snapshot.
"""

from __future__ import annotations

import hmac
import hashlib
import os
import secrets
import struct
import time
from dataclasses import dataclass

from .aesgcm import GcmKey

_MAGIC = b"FSPKS1\n"


@dataclass(frozen=True)
class KeyVersion:
    """(version, key) — reference common/KeyVersion.java."""

    version: int
    key: bytes
    created_at: float

    def gcm(self) -> GcmKey:
        return GcmKey(self.key)


class SecureBytes:
    """Mutable key container supporting best-effort wipe (reference
    SecureKeyDeletion.java:8-32; 4-pass NIST SP 800-88 style)."""

    def __init__(self, data: bytes):
        self._buf = bytearray(data)

    def get(self) -> bytes:
        return bytes(self._buf)

    def wipe(self) -> None:
        n = len(self._buf)
        for fill in (b"\x00", b"\xff", b"\xaa"):
            self._buf[:] = fill * n
        self._buf[:] = secrets.token_bytes(n)
        self._buf[:] = b"\x00" * n


class KeyManager:
    """Master secret + derived session keys, versioned, atomically persisted.

    Forward-security model matches the reference: session-key *copies* are
    deleted once no ciphertext references them; the adversarial games snapshot
    a session key and must fail against re-encrypted data.
    """

    def __init__(self, store_path: str, retention_max: int = 5):
        self.store_path = store_path
        self.retention_max = retention_max
        self._session: dict[int, SecureBytes] = {}
        self._gcm_cache: dict[int, GcmKey] = {}
        self._deleted: set[int] = set()
        self.current_version = 1
        self.created_at = time.time()
        # ratchet state: self._master is M_{epoch_base}, the chain head for
        # the lowest non-deleted version; legacy (format-1) blobs load with
        # _legacy=True and keep the reference's fixed-master derivation so
        # their existing arenas stay openable
        self.epoch_base = 1
        self._legacy = False
        if os.path.exists(store_path):
            self._load()
        else:
            self._master = SecureBytes(secrets.token_bytes(32))
            self.persist()

    # -- derivation ---------------------------------------------------------

    @staticmethod
    def _ratchet_step(m: bytes) -> bytes:
        return hmac.new(m, b"fspann/ratchet", hashlib.sha256).digest()

    def _derive(self, version: int) -> bytes:
        if self._legacy:
            return hmac.new(self._master.get(), struct.pack(">i", version),
                            hashlib.sha256).digest()[:32]
        if version < self.epoch_base:
            # the chain head has ratcheted past this version: its master is
            # cryptographically erased, not merely marked deleted
            raise KeyError(
                f"key version {version} predates the ratchet head "
                f"(epoch base {self.epoch_base}) — cryptographically erased")
        m = self._master.get()
        for _ in range(version - self.epoch_base):
            m = self._ratchet_step(m)
        return hmac.new(m, b"fspann/session", hashlib.sha256).digest()[:32]

    def get_version(self, version: int) -> KeyVersion:
        if version in self._deleted:
            raise KeyError(f"key version {version} has been securely deleted")
        if version < 1 or version > self.current_version:
            raise KeyError(f"unknown key version {version} "
                           f"(current={self.current_version})")
        if version not in self._session:
            self._session[version] = SecureBytes(self._derive(version))
        return KeyVersion(version, self._session[version].get(),
                          self.created_at)

    def gcm_for(self, version: int) -> GcmKey:
        """Expanded GCM context, cached per version (hot path)."""
        if version in self._deleted:
            raise KeyError(f"key version {version} has been securely deleted")
        k = self._gcm_cache.get(version)
        if k is None:
            k = GcmKey(self.get_version(version).key)
            self._gcm_cache[version] = k
        return k

    def current(self) -> KeyVersion:
        return self.get_version(self.current_version)

    # -- rotation / deletion -------------------------------------------------

    def rotate(self) -> KeyVersion:
        self.current_version += 1
        self.persist()
        return self.current()

    def delete_version(self, version: int) -> None:
        """Secure-wipe a session key copy, refuse future derivation, and —
        when the deletion closes the bottom of the live range — RATCHET the
        master chain head past every contiguously-deleted version, wiping
        each predecessor head.  After the ratchet, the persisted blob holds
        only M_{new base}, from which the deleted versions' keys cannot be
        recomputed (G1')."""
        if version >= self.current_version:
            raise ValueError("cannot delete the current or future version")
        sb = self._session.pop(version, None)
        if sb is not None:
            sb.wipe()
        self._gcm_cache.pop(version, None)
        self._deleted.add(version)
        if not self._legacy:
            while self.epoch_base in self._deleted:
                old = self._master
                self._master = SecureBytes(self._ratchet_step(old.get()))
                old.wipe()
                self.epoch_base += 1
        self.persist()

    def live_versions(self) -> list[int]:
        return [v for v in range(1, self.current_version + 1)
                if v not in self._deleted]

    def enforce_retention(self) -> list[int]:
        """Delete oldest versions beyond the retention window
        (reference KeyManager -Dkey.retention.max=5)."""
        live = self.live_versions()
        dropped = []
        while len(live) > self.retention_max:
            v = live.pop(0)
            if v == self.current_version:
                break
            self.delete_version(v)
            dropped.append(v)
        return dropped

    # -- persistence ----------------------------------------------------------

    def persist(self) -> None:
        """Atomic write: temp file + fsync + os.replace
        (reference KeyManager.java:185-219 ATOMIC_MOVE)."""
        blob = bytearray()
        blob += _MAGIC
        fmt = 1 if self._legacy else 2
        blob += struct.pack(">iqd", fmt, self.current_version,
                            self.created_at)
        blob += struct.pack(">i", len(self._deleted))
        for v in sorted(self._deleted):
            blob += struct.pack(">q", v)
        if not self._legacy:
            blob += struct.pack(">q", self.epoch_base)
        blob += self._master.get()
        tmp = self.store_path + ".tmp"
        os.makedirs(os.path.dirname(self.store_path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(bytes(blob))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.store_path)

    def _load(self) -> None:
        raw = open(self.store_path, "rb").read()
        if not raw.startswith(_MAGIC):
            raise ValueError(f"bad keystore magic in {self.store_path}")
        off = len(_MAGIC)
        fmt, cur, created = struct.unpack_from(">iqd", raw, off)
        off += struct.calcsize(">iqd")
        if fmt not in (1, 2):
            raise ValueError(f"unknown keystore format {fmt}")
        (ndel,) = struct.unpack_from(">i", raw, off)
        off += 4
        deleted = set()
        for _ in range(ndel):
            (v,) = struct.unpack_from(">q", raw, off)
            deleted.add(int(v))
            off += 8
        if fmt == 2:
            (base,) = struct.unpack_from(">q", raw, off)
            off += 8
            self.epoch_base = int(base)
            self._legacy = False
        else:
            # reference-compatible fixed-master blob: no ratchet head, keys
            # for every version derive from the one persisted master
            self.epoch_base = 1
            self._legacy = True
        master = raw[off:off + 32]
        if len(master) != 32:
            raise ValueError("truncated keystore")
        self.current_version = int(cur)
        self.created_at = created
        self._deleted = deleted
        self._master = SecureBytes(master)
