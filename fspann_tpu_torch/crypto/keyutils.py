"""Key diagnostics helpers (reference crypto/KeyUtils.java): try-decrypt
probing and raw-bytes key construction for tests/forensics."""

from __future__ import annotations

from .aesgcm import GcmKey
from .keys import KeyVersion


def key_from_bytes(raw: bytes, version: int = 0) -> KeyVersion:
    """Build a KeyVersion from raw bytes (test fixture; reference
    KeyUtils.fromBytes:44-49)."""
    if len(raw) != 32:
        raise ValueError("expected 32-byte AES-256 key")
    return KeyVersion(version, raw, 0.0)


def try_decrypt(key: bytes, iv: bytes, ct_and_tag: bytes,
                aads: list[bytes] = (b"",)) -> bytes | None:
    """Attempt decryption under each candidate AAD; None if all fail
    (diagnostic — used to classify 'wrong key' vs 'wrong AAD' failures)."""
    gcm = GcmKey(key)
    for aad in aads:
        try:
            return gcm.open(iv, ct_and_tag, aad)
        except ValueError:
            continue
    return None
