"""ctypes binding to the native AES-256-GCM kernel (libfspann_crypto.so).

Mirrors the reference's crypto service shapes
(crypto/AesGcmCryptoService.java): AES-256-GCM, 12-byte IV, 128-bit tag,
AAD-bound point encryption.  The batch entry points are the performance
story: the reference decrypts candidates one JCE call at a time
(query/QueryServiceImpl.java:238-271, its dominant per-query cost); here a
whole candidate set is one C call over flat numpy buffers.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import aes_gcm_library_path

_BUILD_LOCK = threading.Lock()
_LIB = None

IV_LEN = 12
TAG_LEN = 16
KEY_LEN = 32


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(aes_gcm_library_path())
        lib.fspann_gcm_ctx_size.restype = ctypes.c_size_t
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        vp = ctypes.c_void_p
        sz = ctypes.c_size_t
        lib.fspann_gcm_init.argtypes = [vp, u8p]
        lib.fspann_gcm_seal.argtypes = [vp, u8p, u8p, sz, u8p, sz, u8p, u8p]
        lib.fspann_gcm_open.argtypes = [vp, u8p, u8p, sz, u8p, sz, u8p, u8p]
        lib.fspann_gcm_open.restype = ctypes.c_int
        lib.fspann_gcm_seal_batch.argtypes = [vp, sz, u8p, u8p, u64p, u64p,
                                              u8p, u64p, u64p, u8p, u8p]
        lib.fspann_gcm_open_batch.argtypes = [vp, sz, u32p, sz, u8p, u8p,
                                              u64p, u64p, u8p, u64p, u64p,
                                              u8p, u8p, u8p]
        lib.fspann_gcm_open_batch.restype = ctypes.c_int
        u32 = ctypes.c_uint32
        lib.fspann_gcm_open_batch_rec.argtypes = [
            vp, sz, u32p, sz, u8p, u64p, u32, u32, u32, ctypes.c_uint64,
            u8p, u64p, u64p, u8p, u64p, u8p]
        lib.fspann_gcm_open_batch_rec.restype = ctypes.c_int
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.fspann_gcm_open_batch_rec_id.argtypes = [
            vp, sz, u8p, u64p, u32, u32, u32, ctypes.c_uint64,
            i64p, u32, u32, u8p, u64p, u8p, f32p, ctypes.c_int,
            ctypes.c_int]
        lib.fspann_gcm_open_batch_rec_id.restype = ctypes.c_int
        lib.fspann_gcm_open_batch_rec_id_scored.argtypes = [
            vp, sz, u8p, u64p, u32, u32, u32, ctypes.c_uint64,
            i64p, u32, u32, u8p, u64p, u8p, f32p, f32p,
            ctypes.c_uint64, f32p, ctypes.c_int, ctypes.c_int]
        lib.fspann_gcm_open_batch_rec_id_scored.restype = ctypes.c_int
        lib.fspann_crc32_rows.argtypes = [u8p, sz, sz, u32p]
        _LIB = lib
        return lib


def crc32_rows(rows: np.ndarray) -> np.ndarray:
    """zlib-compatible CRC32 of each row of a C-contiguous uint8 [n, L]
    matrix — one C call instead of n zlib calls (record framing hot path)."""
    lib = _load()
    n, row_len = rows.shape
    out = np.empty(n, np.uint32)
    assert rows.flags.c_contiguous
    lib.fspann_crc32_rows(_u8(rows.reshape(-1)), n, row_len,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def pack_contexts(keys: list["GcmKey"]):
    """Pack expanded key contexts for the multi-key batch entry points."""
    lib = _load()
    ctx_size = lib.fspann_gcm_ctx_size()
    packed = ctypes.create_string_buffer(ctx_size * max(len(keys), 1))
    for i, k in enumerate(keys):
        ctypes.memmove(ctypes.byref(packed, i * ctx_size), k._ctx, ctx_size)
    return ctypes.cast(packed, ctypes.c_void_p), ctx_size, packed


def open_batch_records(keys: list["GcmKey"], key_idx: np.ndarray,
                       base: np.ndarray, rec_off: np.ndarray,
                       iv_rel: int, ct_rel: int, tag_rel: int, ct_len: int,
                       aads: np.ndarray, pt_flat: np.ndarray,
                       pt_off: np.ndarray) -> np.ndarray:
    """Zero-copy record open: record i's IV/ct/tag are read in place at
    ``base[rec_off[i] + {iv_rel, ct_rel, tag_rel}]`` (e.g. an mmap'd arena);
    plaintext row i is scatter-written at ``pt_flat[pt_off[i]:...+ct_len]``.
    Returns ok uint8 [n]."""
    lib = _load()
    n = len(rec_off)
    ctx_ptr, ctx_size, _keep = pack_contexts(keys)
    aad_buf, aad_off, aad_len = _flat_extents(aads)
    ok = np.empty(n, np.uint8)
    assert pt_flat.flags.c_contiguous
    lib.fspann_gcm_open_batch_rec(
        ctx_ptr, ctx_size,
        key_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
        _u8(base), _u64(np.ascontiguousarray(rec_off, np.uint64)),
        iv_rel, ct_rel, tag_rel, ct_len,
        _u8(aad_buf), _u64(aad_off), _u64(aad_len),
        _u8(pt_flat), _u64(np.ascontiguousarray(pt_off, np.uint64)), _u8(ok))
    return ok


def open_batch_records_by_id(key: "GcmKey", base: np.ndarray,
                             rec_off: np.ndarray,
                             iv_rel: int, ct_rel: int, tag_rel: int,
                             ct_len: int, ids: np.ndarray, key_version: int,
                             dim: int, pt_flat: np.ndarray,
                             pt_off: np.ndarray,
                             norms: np.ndarray | None = None,
                             payload_kind: int = 0) -> np.ndarray:
    """Single-key record open with the 32-byte AAD synthesized in C from
    (id, key_version, dim) — the query hot path.  Building the AAD matrix in
    numpy costs a full DRAM pass over the candidate set; in C it is a stack
    buffer touched in L1 right before GHASH (scripts/profile_decrypt.py
    measured the numpy pass as large as the AES itself).

    ``norms`` (f32, at least pt_off.max()/ct_len+1 long): per-row squared L2
    of the decrypted f32 payload, computed while the row is in L1 — saves
    the refine stage a full re-read of the candidate matrix.

    Parallelism: FSPANN_THREADS=N splits the batch across N pthreads
    (disjoint output ranges — race-free); "auto" = os.cpu_count().  The
    decrypt stage is the serving bottleneck and scales linearly with cores."""
    lib = _load()
    n = len(rec_off)
    ok = np.empty(n, np.uint8)
    assert pt_flat.flags.c_contiguous
    ids = np.ascontiguousarray(ids, np.int64)
    norms_ptr = None if norms is None else \
        norms.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.fspann_gcm_open_batch_rec_id(
        key.ctx, n,
        _u8(base), _u64(np.ascontiguousarray(rec_off, np.uint64)),
        iv_rel, ct_rel, tag_rel, ct_len,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        key_version, dim,
        _u8(pt_flat), _u64(np.ascontiguousarray(pt_off, np.uint64)), _u8(ok),
        norms_ptr, _num_threads(), int(payload_kind))
    return ok


def open_batch_records_scored(key: "GcmKey", base: np.ndarray,
                              rec_off: np.ndarray,
                              iv_rel: int, ct_rel: int, tag_rel: int,
                              ct_len: int, ids: np.ndarray, key_version: int,
                              dim: int, pt_off: np.ndarray,
                              norms: np.ndarray, dots: np.ndarray,
                              qvecs: np.ndarray, rows_per_query: int,
                              payload_kind: int = 0) -> np.ndarray:
    """Fused decrypt-and-score: like :func:`open_batch_records_by_id` but the
    plaintext NEVER reaches DRAM — each record is decrypted into an
    L1-resident scratch row, and its squared L2 norm plus the dot product
    against ``qvecs[(pt_off[i]/row_stride) // rows_per_query]`` are written
    to ``norms``/``dots`` (f32, indexed by output row).  The refine stage
    needs only ``d2 = norms - 2*dots + |q|^2``, so BOTH candidate-matrix
    passes of the unfused path (staging write + score re-read) disappear —
    the dominant serving cost on a memory-bandwidth-bound host.

    ``qvecs`` must be C-contiguous f32 [n_queries, dim]."""
    lib = _load()
    n = len(rec_off)
    ok = np.empty(n, np.uint8)
    ids = np.ascontiguousarray(ids, np.int64)
    qvecs = np.ascontiguousarray(qvecs, np.float32)
    assert qvecs.shape[1] == dim and norms.dtype == np.float32 \
        and dots.dtype == np.float32
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fspann_gcm_open_batch_rec_id_scored(
        key.ctx, n,
        _u8(base), _u64(np.ascontiguousarray(rec_off, np.uint64)),
        iv_rel, ct_rel, tag_rel, ct_len,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        key_version, dim,
        None, _u64(np.ascontiguousarray(pt_off, np.uint64)), _u8(ok),
        norms.ctypes.data_as(f32p),
        qvecs.ctypes.data_as(f32p), rows_per_query,
        dots.ctypes.data_as(f32p),
        _num_threads(), int(payload_kind))
    return ok


def _num_threads() -> int:
    """FSPANN_THREADS: decrypt-stage thread count (default 1; 'auto' =
    cpu count).  Re-read per call so tests/operators can flip it live."""
    v = os.environ.get("FSPANN_THREADS", "1")
    if v == "auto":
        return os.cpu_count() or 1
    try:
        return max(1, int(v))
    except ValueError:
        return 1


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class GcmKey:
    """Expanded AES-256-GCM context for one key."""

    __slots__ = ("_ctx", "key_bytes_fingerprint")

    def __init__(self, key: bytes):
        if len(key) != KEY_LEN:
            raise ValueError(f"AES-256 key must be {KEY_LEN} bytes")
        lib = _load()
        self._ctx = ctypes.create_string_buffer(lib.fspann_gcm_ctx_size())
        kb = np.frombuffer(key, np.uint8)
        lib.fspann_gcm_init(ctypes.cast(self._ctx, ctypes.c_void_p), _u8(kb))

    @property
    def ctx(self):
        return ctypes.cast(self._ctx, ctypes.c_void_p)

    def seal(self, iv: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
        """Returns ciphertext || 16-byte tag."""
        lib = _load()
        n = len(plaintext)
        pt = np.frombuffer(plaintext, np.uint8) if n else np.zeros(0, np.uint8)
        aadb = np.frombuffer(aad, np.uint8) if aad else np.zeros(0, np.uint8)
        ivb = np.frombuffer(iv, np.uint8)
        ct = np.empty(n, np.uint8)
        tag = np.empty(TAG_LEN, np.uint8)
        lib.fspann_gcm_seal(self.ctx, _u8(ivb), _u8(aadb), len(aad),
                            _u8(pt), n, _u8(ct), _u8(tag))
        return ct.tobytes() + tag.tobytes()

    def open(self, iv: bytes, ct_and_tag: bytes, aad: bytes = b"") -> bytes:
        """Raises ValueError on tag mismatch."""
        lib = _load()
        if len(ct_and_tag) < TAG_LEN:
            raise ValueError("ciphertext shorter than tag")
        ct_b, tag_b = ct_and_tag[:-TAG_LEN], ct_and_tag[-TAG_LEN:]
        n = len(ct_b)
        ct = np.frombuffer(ct_b, np.uint8) if n else np.zeros(0, np.uint8)
        tag = np.frombuffer(tag_b, np.uint8)
        aadb = np.frombuffer(aad, np.uint8) if aad else np.zeros(0, np.uint8)
        ivb = np.frombuffer(iv, np.uint8)
        pt = np.empty(n, np.uint8)
        rc = lib.fspann_gcm_open(self.ctx, _u8(ivb), _u8(aadb), len(aad),
                                 _u8(ct), n, _u8(tag), _u8(pt))
        if rc != 0:
            raise ValueError("GCM tag verification failed")
        return pt.tobytes()


def _flat_extents(chunks) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Accepts a list of bytes OR a uint8 [n, L] matrix (fixed-width fast
    path used for AAD batches)."""
    if isinstance(chunks, np.ndarray):
        n, width = chunks.shape
        buf = np.ascontiguousarray(chunks).reshape(-1)
        offs = np.arange(n, dtype=np.uint64) * width
        lens = np.full(n, width, np.uint64)
        return buf, offs, lens
    lens = np.array([len(c) for c in chunks], np.uint64)
    offs = np.zeros(len(chunks), np.uint64)
    if len(chunks):
        np.cumsum(lens[:-1], out=offs[1:])
    buf = np.frombuffer(b"".join(chunks), np.uint8) if chunks else \
        np.zeros(0, np.uint8)
    return buf, offs, lens


def seal_batch(key: GcmKey, ivs: np.ndarray, aads: list[bytes],
               pt: np.ndarray, offs: np.ndarray,
               lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Seal n records under one key.

    ivs: uint8 [n, 12]; pt: flat uint8 buffer with (offs, lens) extents.
    Returns (ct flat uint8 — same extents, tags uint8 [n, 16]).
    """
    lib = _load()
    n = len(lens)
    aad_buf, aad_off, aad_len = _flat_extents(aads)
    ct = np.empty_like(pt)
    tags = np.empty((n, TAG_LEN), np.uint8)
    lib.fspann_gcm_seal_batch(key.ctx, n, _u8(ivs), _u8(aad_buf),
                              _u64(aad_off), _u64(aad_len), _u8(pt),
                              _u64(offs), _u64(lens), _u8(ct), _u8(tags))
    return ct, tags


def open_batch(keys: list[GcmKey], key_idx: np.ndarray, ivs: np.ndarray,
               aads: list[bytes], ct: np.ndarray, offs: np.ndarray,
               lens: np.ndarray,
               tags: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Open n records, record i under keys[key_idx[i]] (multi-version batch —
    candidates carry their own key versions, reference
    QueryServiceImpl.java:250-251).

    Returns (pt flat uint8 — same extents, ok uint8 [n]).
    """
    lib = _load()
    n = len(lens)
    ctx_size = lib.fspann_gcm_ctx_size()
    packed = ctypes.create_string_buffer(ctx_size * max(len(keys), 1))
    for i, k in enumerate(keys):
        ctypes.memmove(ctypes.byref(packed, i * ctx_size), k._ctx, ctx_size)
    aad_buf, aad_off, aad_len = _flat_extents(aads)
    pt = np.empty_like(ct)
    ok = np.empty(n, np.uint8)
    lib.fspann_gcm_open_batch(ctypes.cast(packed, ctypes.c_void_p), ctx_size,
                              key_idx.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_uint32)),
                              n, _u8(ivs), _u8(aad_buf), _u64(aad_off),
                              _u64(aad_len), _u8(ct), _u64(offs), _u64(lens),
                              _u8(tags), _u8(pt), _u8(ok))
    return pt, ok


# ----------------------------------------------------------------------------
# NIST CAVP / McGrew-Viega test vectors (AES-256-GCM)
# ----------------------------------------------------------------------------

_VECTORS = [
    # (key, iv, pt, aad, ct, tag) — test cases 13, 14, 16 of the GCM spec
    ("00" * 32, "00" * 12, "", "", "", "530f8afbc74536b9a963b4f1c4cb738b"),
    ("00" * 32, "00" * 12, "00" * 16, "",
     "cea7403d4d606b6e074ec5d3baf39d18", "d0d1c8a799996bf0265b98b5d48ab919"),
    ("feffe9928665731c6d6a8f9467308308feffe9928665731c6d6a8f9467308308",
     "cafebabefacedbaddecaf888",
     "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
     "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b39",
     "feedfacedeadbeeffeedfacedeadbeefabaddad2",
     "522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
     "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662",
     "76fc6ece0f4e1768cddf8853bb2d551b"),
]


def selftest() -> None:
    """Validate the native kernel against published AES-256-GCM vectors."""
    for key, iv, pt, aad, ct, tag in _VECTORS:
        k = GcmKey(bytes.fromhex(key))
        sealed = k.seal(bytes.fromhex(iv), bytes.fromhex(pt),
                        bytes.fromhex(aad))
        expect = bytes.fromhex(ct) + bytes.fromhex(tag)
        if sealed != expect:
            raise AssertionError(
                f"GCM selftest seal mismatch: got {sealed.hex()} "
                f"want {expect.hex()}")
        opened = k.open(bytes.fromhex(iv), sealed, bytes.fromhex(aad))
        if opened != bytes.fromhex(pt):
            raise AssertionError("GCM selftest open mismatch")
        # tamper detection
        bad = bytearray(sealed)
        bad[-1] ^= 1
        try:
            k.open(bytes.fromhex(iv), bytes(bad), bytes.fromhex(aad))
            raise AssertionError("GCM selftest: tampered tag accepted")
        except ValueError:
            pass
