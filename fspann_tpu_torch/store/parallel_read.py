"""The binding of the candidate read's native pass
(``csrc/native/open_pool.c``): the metadata lookup, the arena bounds guard
and the AES-256-GCM open of each candidate, cut into chunks that a
persistent pool of host threads takes in turn.

:meth:`~.point_store.PointStore.load_decrypt_batch` and
:meth:`~.point_store.PointStore.load_score_batch` build the key-version
table from the store's state and call :func:`open_records`; this module
knows nothing of the store.

The pool is as wide as the cores this process may run on, capped by
``FSPANN_THREADS`` where that is set.  A read of fewer than
:data:`INLINE_BELOW` candidates runs on the caller's thread alone: waking
the pool costs more than it saves there.  The set-up's host work (the
encode's chunks, the partition tables' sorts) runs as wide, on
``utils/threads.map_threads``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

from .._build import open_pool_library_path
from ..crypto import aesgcm

# candidates below which a read runs on the caller's thread alone: on the
# H100 host's 8 cores, with the workers asleep, 8 threads read 768
# candidates in 0.62 ms against one thread's 0.52, 1,024 in 0.58 against
# 0.60 and 1,600 in 0.57 against 0.74 (medians of 300 reads of a 1M-row
# f16 store, in turns)
INLINE_BELOW = 1024

_LOAD_LOCK = threading.Lock()
_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(open_pool_library_path())
            vp, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
            u32, u64 = ctypes.c_uint32, ctypes.c_uint64
            lib.fspann_open_pool_run.argtypes = [
                sz, vp, vp, vp, vp, u64, u32, vp, vp, vp, u32, u32, i, vp,
                vp, vp, vp, u64, vp, i, ctypes.POINTER(i)]
            lib.fspann_open_pool_run.restype = i
            lib.fspann_open_pool_threads.argtypes = []
            lib.fspann_open_pool_threads.restype = i
            _LIB = lib
    return _LIB


@functools.cache
def _usable_cores() -> int:
    """The cores this process may run on, asked once: the read is on every
    query's path, and the question is a system call."""
    return len(os.sched_getaffinity(0))


def default_width() -> int:
    """Threads a read may use: the cores this process may run on, capped by
    ``FSPANN_THREADS`` where it is set."""
    n = _usable_cores()
    if "FSPANN_THREADS" in os.environ:
        n = min(n, aesgcm._num_threads())
    return n


def pool_threads() -> int:
    """Workers the process's pool has started (the callers not counted)."""
    return _load().fspann_open_pool_threads()


def _ptr(a: np.ndarray | None) -> int | None:
    return None if a is None else a.ctypes.data


def open_records(ids: np.ndarray, rows: np.ndarray | None,
                 meta_kv: np.ndarray, meta_off: np.ndarray,
                 table: np.ndarray, body: int, dim: int, payload_kind: int,
                 pt: np.ndarray | None, norms: np.ndarray | None,
                 dots: np.ndarray | None, qvecs: np.ndarray | None,
                 rows_per_query: int) -> tuple[np.ndarray, int, int]:
    """The native pass over ``ids`` (contiguous int64), each slot ``s``
    written at output row ``rows[s]`` (``s`` where ``rows`` is None).

    ``meta_kv`` / ``meta_off`` are the metadata's int32 key versions and
    int64 arena offsets by id; ``table`` is uint64 [3, versions]: each key
    version's expanded-key address (0: not readable), arena base address
    and arena bytes.  ``pt`` (f32 rows) selects the staging mode, else
    ``qvecs`` the score mode.  The caller has checked every length and
    keeps the keys and arenas alive.  The pass runs on
    :func:`default_width` threads, on one below :data:`INLINE_BELOW`
    candidates.

    Returns (ok uint8 [n], threads that took a chunk, failed tags)."""
    n = len(ids)
    if meta_kv.dtype != np.int32 or meta_off.dtype != np.int64:
        raise TypeError("metadata arrays must be int32 key versions and "
                        "int64 arena offsets")
    table = np.ascontiguousarray(table, np.uint64)
    width = 1 if n < INLINE_BELOW else default_width()
    ok = np.empty(n, np.uint8)
    workers = ctypes.c_int(0)
    failed = _load().fspann_open_pool_run(
        n, _ptr(ids), _ptr(rows), _ptr(meta_kv), _ptr(meta_off),
        len(meta_kv), table.shape[1], _ptr(table[0]), _ptr(table[1]),
        _ptr(table[2]), body, dim, payload_kind, _ptr(pt), _ptr(norms),
        _ptr(dots), _ptr(qvecs), rows_per_query, _ptr(ok), width,
        ctypes.byref(workers))
    return ok, workers.value, failed
