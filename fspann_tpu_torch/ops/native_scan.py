"""ctypes binding to the native packed Hamming scan (libfspann_scan.so).

The host twin of the device scan (:mod:`ops.hamming_scan`): XOR+popcount
over the PACKED uint32 code words (AVX-512 VPOPCNTDQ when the host has it)
with exact histogram top-L selection.  The torch scan on the CPU scores
through the unpacked int8 bit matrix, 8 bytes of stream traffic per code
bit per query batch; this kernel streams the packed words once.

The library is built from the port's copy of the C source,
``csrc/native/hamming_topl.c``, into the port's build directory
(:func:`fspann_tpu_torch._build.native_scan_library_path`); a failed build
raises.

Results are bit-interchangeable with the device scan: same Hamming scores
(popcount(q XOR c) == popc[c] - 2<q,c> + popc[q]), same (score,
id)-ascending order as :func:`ops.hamming_scan.scan_chunk_merge`, same
RouteResult contract (ids -1 / scores INT32_MAX pads, per-query adaptive
decrypt budget) — but as numpy arrays on the host.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import native_scan_library_path
from .routing import RouteResult

_BUILD_LOCK = threading.Lock()
_LIB = None
_INF = np.int32(np.iinfo(np.int32).max)


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(native_scan_library_path())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.fspann_hamming_topl.argtypes = [
            u32p, ctypes.c_uint64, ctypes.c_uint32,
            u32p, ctypes.c_uint32,
            u8p, ctypes.c_uint32, i32p, i32p, ctypes.c_int]
        lib.fspann_hamming_topl.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the native library is present or buildable."""
    try:
        _load()
        return True
    except Exception:
        return False


def _num_threads() -> int:
    v = os.environ.get("FSPANN_SCAN_THREADS",
                       os.environ.get("FSPANN_THREADS", "1"))
    if v == "auto":
        return os.cpu_count() or 1
    try:
        return max(1, int(v))
    except ValueError:
        return 1


def hamming_topl(words: np.ndarray, qwords: np.ndarray,
                 dead: np.ndarray | None, limit: int,
                 threads: int | None = None):
    """Exact top-``limit`` by Hamming distance: ids int32 [Q, L] (-1 pad),
    scores int32 [Q, L] (INT32_MAX pad), n_live (total non-dead rows).

    ``words``/``qwords`` are the packed uint32 codes ([N, G, W] or
    [N, G*W]); group pad bits must be zero in both (the packers'
    invariant, ops/coding.py)."""
    lib = _load()
    words = np.ascontiguousarray(words.reshape(len(words), -1), np.uint32)
    qwords = np.ascontiguousarray(qwords.reshape(len(qwords), -1),
                                  np.uint32)
    n, w32 = words.shape
    q = len(qwords)
    if qwords.shape[1] != w32:
        raise ValueError("corpus/query word width mismatch")
    limit = max(1, min(int(limit), n))
    dead_arr = None
    dead_ptr = None
    if dead is not None:
        dead_arr = np.ascontiguousarray(np.asarray(dead), np.uint8)
        if len(dead_arr) != n:
            raise ValueError("dead mask length mismatch")
        dead_ptr = dead_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    ids = np.empty((q, limit), np.int32)
    scores = np.empty((q, limit), np.int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n_live = lib.fspann_hamming_topl(
        words.ctypes.data_as(u32p), n, w32,
        qwords.ctypes.data_as(u32p), q,
        dead_ptr, limit,
        ids.ctypes.data_as(i32p), scores.ctypes.data_as(i32p),
        _num_threads() if threads is None else threads)
    if n_live < 0:
        raise MemoryError("native scan allocation failed")
    return ids, scores, n_live


def _adaptive_count_numpy(scores: np.ndarray, anchor: int, margin: int,
                          floor: int, k: int) -> np.ndarray:
    """Numpy twin of :func:`ops.hamming_scan._adaptive_count` (kept in
    lockstep — the adaptive decrypt budget must not depend on which scan
    backend served the batch)."""
    a = max(min(anchor, k), 1)
    s_a = scores[:, a - 1].astype(np.int64)
    thresh = np.minimum(s_a, int(_INF) - margin - 1) + margin
    n_dec = np.sum(scores <= thresh[:, None], axis=-1).astype(np.int32)
    return np.clip(n_dec, min(max(floor, a), k), k)


def scan_topl(codes: np.ndarray, qcodes: np.ndarray,
              dead: np.ndarray | None, limit: int,
              anchor: int = 0, margin: int = 0,
              floor: int = 0) -> RouteResult:
    """Stage A via the native kernel, with the device scan's RouteResult
    contract (:func:`ops.hamming_scan.scan`): ranked ids/scores, per-query
    live counts, and the adaptive decrypt budget when ``margin`` > 0 — as
    numpy arrays."""
    ids, scores, n_live = hamming_topl(codes, qcodes, dead, limit)
    q, k = ids.shape
    per_q = np.full(q, min(k, n_live), np.int32)
    n_dec = _adaptive_count_numpy(scores, anchor, margin, floor, k) \
        if margin > 0 else None
    return RouteResult(ids, scores, per_q,
                       np.full(q, codes.shape[0], np.int32), n_dec)
