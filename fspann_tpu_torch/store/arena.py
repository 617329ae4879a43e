"""Per-key-version ciphertext arenas.

The reference persists one Java-serialized file per point
(``common/RocksDBMetadataManager.java:342-375`` — temp file + ATOMIC_MOVE per
point, a metadata put per point).  One million vectors = one million files
and a metadata round-trip per insert; the decrypt-and-refine stage then pays
a file open per candidate (``loadEncryptedPoint`` :530-544).

Here each key version owns a single append-only arena file.  A record is::

    u32 magic | u32 id | u32 key_version | u32 dim | u32 ct_len | 12B iv |
    ct||tag | u32 crc32(header+payload)

Candidate reads are numpy gathers out of an mmap — thousands of ciphertexts
per syscall-free batch.  Version retirement deletes one file (paired with
secure key deletion); re-encryption appends to the new version's arena and
the old record becomes garbage, collected when its version retires.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib

import numpy as np

_MAGIC = 0xF5BA17EC
_HDR = struct.Struct("<IIIII12s")   # magic, id, kv, dim, ct_len, iv
_CRC = struct.Struct("<I")


class ArenaWriter:
    """Append-only writer for one key version's arena."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        self.offset = self._f.tell()

    def append(self, point_id: int, key_version: int, dim: int, iv: bytes,
               ct_and_tag: bytes) -> tuple[int, int]:
        """Returns (offset, record_len)."""
        hdr = _HDR.pack(_MAGIC, point_id, key_version, dim, len(ct_and_tag), iv)
        crc = zlib.crc32(hdr)
        crc = zlib.crc32(ct_and_tag, crc)
        rec = hdr + ct_and_tag + _CRC.pack(crc)
        off = self.offset
        self._f.write(rec)
        self.offset += len(rec)
        return off, len(rec)

    def append_batch(self, ids: np.ndarray, key_version: int, dim: int,
                     ivs: np.ndarray, ct_tag: np.ndarray) -> np.ndarray:
        """Vectorized append of n uniform-length records in one write.

        ivs: uint8 [n, 12]; ct_tag: uint8 [n, ct_len].  Returns offsets
        int64 [n].  Record layout identical to append().
        """
        n = len(ids)
        ct_len = ct_tag.shape[1]
        rec_len = _HDR.size + ct_len + _CRC.size
        buf = np.zeros((n, rec_len), np.uint8)
        hdr = buf[:, :_HDR.size]
        hdr[:, 0:4] = np.frombuffer(np.uint32(_MAGIC).tobytes(), np.uint8)
        hdr[:, 4:8] = np.ascontiguousarray(
            ids.astype("<u4")).view(np.uint8).reshape(n, 4)
        hdr[:, 8:12] = np.frombuffer(np.uint32(key_version).tobytes(), np.uint8)
        hdr[:, 12:16] = np.frombuffer(np.uint32(dim).tobytes(), np.uint8)
        hdr[:, 16:20] = np.frombuffer(np.uint32(ct_len).tobytes(), np.uint8)
        hdr[:, 20:32] = ivs
        buf[:, _HDR.size:_HDR.size + ct_len] = ct_tag
        # per-record crc32 (header+payload) in one native call
        from ..crypto.aesgcm import crc32_rows
        body = np.ascontiguousarray(buf[:, :_HDR.size + ct_len])
        crcs = crc32_rows(body).astype("<u4")
        buf[:, -4:] = crcs.view(np.uint8).reshape(n, 4)
        offs = self.offset + np.arange(n, dtype=np.int64) * rec_len
        self._f.write(buf.tobytes())
        self.offset += n * rec_len
        return offs

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()


class ArenaReader:
    """mmap-backed random access into one arena file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        size = os.fstat(self._f.fileno()).st_size
        self._mm = (mmap.mmap(self._f.fileno(), size, access=mmap.ACCESS_READ)
                    if size else None)
        self._buf = (np.frombuffer(self._mm, np.uint8) if self._mm is not None
                     else np.zeros(0, np.uint8))

    @property
    def size(self) -> int:
        return len(self._buf)

    def read_record(self, offset: int, verify_crc: bool = False):
        """Parse one record: (id, key_version, dim, iv, ct_and_tag)."""
        hdr = bytes(self._buf[offset:offset + _HDR.size])
        if len(hdr) < _HDR.size:
            raise ValueError(f"truncated record at {offset} in {self.path}")
        magic, pid, kv, dim, ct_len, iv = _HDR.unpack(hdr)
        if magic != _MAGIC:
            raise ValueError(f"bad record magic at {offset} in {self.path}")
        start = offset + _HDR.size
        ct = bytes(self._buf[start:start + ct_len])
        if len(ct) < ct_len:
            raise ValueError(f"truncated payload at {offset} in {self.path}")
        if verify_crc:
            (want,) = _CRC.unpack(
                bytes(self._buf[start + ct_len:start + ct_len + _CRC.size]))
            got = zlib.crc32(ct, zlib.crc32(hdr))
            if got != want:
                raise ValueError(f"CRC mismatch at {offset} in {self.path}")
        return pid, kv, dim, iv, ct

    def gather(self, offsets: np.ndarray, ct_len: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Bulk-read n same-length records: returns (ivs uint8 [n,12],
        ct flat uint8 [n*ct_len]).  The refine hot path."""
        offs = np.asarray(offsets, np.int64)
        rec_len = _HDR.size + ct_len + _CRC.size
        hdr_iv_off = _HDR.size - 12
        if len(offs) and (offs % rec_len == 0).all():
            # uniform-record arena (the normal case: one dim per store) —
            # a row gather out of a [nrec, rec_len] view is memcpy-speed,
            # unlike elementwise fancy indexing with an [n, rec_len] index
            # matrix (~100x slower at refine-batch scale)
            nrec = self.size // rec_len
            mat = self._buf[:nrec * rec_len].reshape(nrec, rec_len)
            rows = mat[offs // rec_len]
            ivs = rows[:, hdr_iv_off:_HDR.size]
            cts = np.ascontiguousarray(
                rows[:, _HDR.size:_HDR.size + ct_len]).reshape(-1)
            return np.ascontiguousarray(ivs), cts
        offs = offs[:, None]
        ivs = self._buf[offs + hdr_iv_off + np.arange(12, dtype=np.int64)]
        cts = self._buf[offs + _HDR.size +
                        np.arange(ct_len, dtype=np.int64)].reshape(-1)
        return ivs, cts

    def scan(self):
        """Iterate (offset, id, key_version, dim, iv, ct) over the whole
        arena, stopping at the first truncated/corrupt record (crash tail)."""
        off = 0
        n = self.size
        while off + _HDR.size + _CRC.size <= n:
            try:
                pid, kv, dim, iv, ct = self.read_record(off, verify_crc=True)
            except ValueError:
                return
            yield off, pid, kv, dim, iv, ct
            off += _HDR.size + len(ct) + _CRC.size

    def close(self) -> None:
        if self._mm is not None:
            self._buf = np.zeros(0, np.uint8)
            self._mm.close()
        self._f.close()


def secure_delete_arena(path: str) -> None:
    """Overwrite with zeros then unlink (best-effort; pairs with key
    deletion so retired ciphertexts are not just unlinked)."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        chunk = b"\x00" * (1 << 20)
        left = size
        while left > 0:
            f.write(chunk[:min(left, len(chunk))])
            left -= min(left, len(chunk))
        f.flush()
        os.fsync(f.fileno())
    os.remove(path)
