"""A batch's candidate read on every host core: the query service's reader
for a :class:`~.point_store.PointStore`.

:func:`score_batch` and :func:`decrypt_batch` return exactly what the
store's own ``load_score_batch`` and ``load_decrypt_batch`` return (``ok``,
norms, dots, staging rows, the same slots left untouched or zeroed), but
the whole read is one native pass (``csrc/native/open_pool.c``): the
metadata lookup, the arena bounds guard and the AES-256-GCM open of each
candidate, cut into chunks that a persistent pool of host threads takes in
turn.  The store's methods stay as they are: the sharded store, the
re-encryption and every other caller keep them.

The pool is as wide as the cores this process may run on, capped by
``FSPANN_THREADS`` where that is set (the store's own threaded open reads
the same variable).  A read of fewer than :data:`INLINE_BELOW` candidates
runs on the caller's thread alone: waking the pool costs more than it
saves there.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

from .._build import open_pool_library_path
from ..crypto import aesgcm
from ..utils.profiler import count, span
from .point_store import PointStore

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
                sz, vp, vp, vp, u64, u32, vp, vp, vp, u32, u32, i, vp, vp,
                vp, vp, u64, vp, i, ctypes.POINTER(i)]
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


def _read(store: PointStore, ids: np.ndarray, pt: np.ndarray | None,
          norms: np.ndarray | None, dots: np.ndarray | None,
          qvecs: np.ndarray | None, rows_per_query: int,
          width: int | None) -> np.ndarray:
    """The native pass over ``ids`` (store lock held); returns ok uint8."""
    lib = _load()
    n = len(ids)
    with span("store.lookup"):
        meta = store.meta
        kv, off = meta._kv, meta._off
        if kv.dtype != np.int32 or off.dtype != np.int64:
            raise TypeError("metadata arrays must be int32 key versions and "
                            "int64 arena offsets")
        # one row per key version up to the newest live one: its expanded
        # key and its arena as mapped now
        versions = sorted(meta.live_versions())
        rows = versions[-1] + 1 if versions else 1
        ctxs = np.zeros(rows, np.uint64)
        bases = np.zeros(rows, np.uint64)
        sizes = np.zeros(rows, np.uint64)
        keep = []
        for v in versions:
            key, reader = store.km.gcm_for(v), store._reader(v)
            keep.append((key, reader._buf))
            ctxs[v] = ctypes.addressof(key._ctx)
            bases[v] = reader._buf.ctypes.data
            sizes[v] = reader.size
        if width is None:
            width = 1 if n < INLINE_BELOW else default_width()
        ok = np.empty(n, np.uint8)
    with span("store.open"):
        workers = ctypes.c_int(0)
        lib.fspann_open_pool_run(
            n, _ptr(ids), _ptr(kv), _ptr(off), len(kv), rows, _ptr(ctxs),
            _ptr(bases), _ptr(sizes), store._body, store.dim,
            store._payload_kind, _ptr(pt), _ptr(norms), _ptr(dots),
            _ptr(qvecs), rows_per_query, _ptr(ok), int(width),
            ctypes.byref(workers))
    count("store.open.workers", workers.value)
    return ok


def score_batch(store: PointStore, ids: np.ndarray, qvecs: np.ndarray,
                rows_per_query: int, norms_out: np.ndarray,
                dots_out: np.ndarray, width: int | None = None
                ) -> np.ndarray:
    """``store.load_score_batch(ids, qvecs, rows_per_query, norms_out,
    dots_out)`` on the pool: each candidate's squared norm and its dot with
    ``qvecs[i // rows_per_query]``, zeros where ``ok`` is False.  Returns
    ok bool [n].  ``width`` forces the threads (default: every usable core,
    one below :data:`INLINE_BELOW` candidates)."""
    ids = np.ascontiguousarray(ids, np.int64)
    n = len(ids)
    if norms_out.dtype != np.float32 or dots_out.dtype != np.float32:
        raise ValueError("norms_out/dots_out must be f32")
    if len(norms_out) < n or len(dots_out) < n:
        raise ValueError("norms_out/dots_out too short")
    if not (norms_out.flags.c_contiguous and dots_out.flags.c_contiguous):
        raise ValueError("norms_out/dots_out must be contiguous")
    if rows_per_query < 1:
        raise ValueError("rows_per_query must be >= 1")
    qvecs = np.ascontiguousarray(qvecs, np.float32)
    if qvecs.ndim != 2 or qvecs.shape[1] != store.dim:
        raise ValueError("qvecs must be [n_queries, dim]")
    # the native pass reads qvecs[slot // rows_per_query] unchecked
    if len(qvecs) * rows_per_query < n:
        raise ValueError("qvecs rows cover fewer slots than needed")
    with store._lock:
        ok = _read(store, ids, None, norms_out, dots_out, qvecs,
                   rows_per_query, width)
    return ok.view(bool)


def decrypt_batch(store: PointStore, ids: np.ndarray,
                  out: np.ndarray | None = None,
                  norms_out: np.ndarray | None = None,
                  width: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """``store.load_decrypt_batch(ids, out, norms_out)`` on the pool: (vecs
    f32 [n, dim] or ``out``, ok bool [n]).  Rows that never reach an open
    (absent, tombstoned, out of the arena) are left as they were, as the
    store's method leaves them; a failed tag zeroes its row and norm."""
    ids = np.ascontiguousarray(ids, np.int64)
    n = len(ids)
    if out is not None:
        if out.ndim != 2 or out.shape[1] != store.dim or out.shape[0] < n \
                or out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous f32 [>=n, dim]")
        vecs = out
    else:
        vecs = np.zeros((n, store.dim), np.float32)
    if norms_out is not None and (
            norms_out.dtype != np.float32 or len(norms_out) < n
            or not norms_out.flags.c_contiguous):
        raise ValueError("norms_out must be contiguous f32 [>=n]")
    with store._lock:
        ok = _read(store, ids, vecs, norms_out, None, None, 1, width)
    return vecs, ok.view(bool)
