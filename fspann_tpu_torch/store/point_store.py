"""Encrypted point store: versioned arenas + metadata log + batch crypto.

This layer is the reference's ``AesGcmCryptoService`` + ``RocksDBMetadataManager``
pair fused around batches: vectors are serialized in the storage dtype
(little-endian f32, f16, or per-row-scaled i8 — the quantized kinds cut
the decrypt stage's arena traffic 2x/4x on a bandwidth-bound host),
sealed with AES-256-GCM under AAD ``id:{id}|v:{kv}|d:{dim}`` (reference
crypto/AesGcmCryptoService.java:72-83), appended to the key version's arena,
then committed via the metadata log.  Candidate loading is the query hot
path: ONE native pass over the whole candidate set on the host's cores
(``csrc/native/open_pool.c`` through ``parallel_read.py``) does the metadata
lookup, the arena bounds guard and the multi-key GCM open (reference
decrypts one point per JCE call — QueryServiceImpl.java:238-271).

A carried copy of the JAX package's module, held equal to it member by
member, except the port's own read: ``load_decrypt_batch``,
``load_score_batch`` and ``_open_records``, held to the JAX package's
methods by behaviour (``tests/test_torch_parallel_read.py``).

Routing–ciphertext orthogonality: nothing in this module touches routing
state; re-encryption rewrites arena records and metadata only.
"""

from __future__ import annotations

import ctypes
import functools
import os
import secrets
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..crypto import aesgcm
from ..crypto.keys import KeyManager
from ..types import aad_batch, aad_for
from ..utils.profiler import count, span
from . import parallel_read
from .arena import ArenaReader, ArenaWriter, secure_delete_arena
from .metadata import MetadataLog

TAG_LEN = aesgcm.TAG_LEN


@dataclass
class ReencryptReport:
    """Reference common/ReencryptReport.java."""

    touched: int
    reencrypted: int
    skipped_current: int
    failed: int
    time_ms: float
    bytes_delta: int
    bytes_after: int


def _parse_arena_name(name: str) -> tuple[int, int] | None:
    """``v{kv}.arena`` -> (kv, 0); ``v{kv}.e{epoch}.arena`` -> (kv, epoch);
    anything else -> None."""
    if not (name.startswith("v") and name.endswith(".arena")):
        return None
    stem = name[1:-len(".arena")]
    kv_s, _, e_s = stem.partition(".")
    try:
        if not e_s:
            return int(kv_s), 0
        if e_s.startswith("e"):
            return int(kv_s), int(e_s[1:])
    except ValueError:
        pass
    return None


def _locked(method):
    """Serialize store operations (see PointStore._lock rationale)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return wrapper


class PointStore:
    def __init__(self, base_dir: str, key_manager: KeyManager, dim: int,
                 dtype: str = "f32"):
        if dtype not in ("f32", "f16", "i8"):
            raise ValueError(
                f"storage dtype must be f32|f16|i8, got {dtype!r}")
        self.base_dir = base_dir
        self.km = key_manager
        self.dim = dim
        self.dtype = dtype
        self.itemsize = {"f32": 4, "f16": 2, "i8": 1}[dtype]
        self.np_dtype = {"f32": "<f4", "f16": "<f2", "i8": "<i1"}[dtype]
        # payload kind for the C open loop (aes_gcm.c payload_kind):
        # 0 = f32 rows, 1 = f16 rows, 2 = i8 rows with an in-ciphertext
        # per-row f32 scale prefix (v_j = scale * q_j, scale = max|v|/127 —
        # the scale is confidential AND tag-authenticated because it rides
        # inside the sealed payload, not the record header)
        self._payload_kind = {"f32": 0, "f16": 1, "i8": 2}[dtype]
        # serialized payload length: i8 rows carry the 4-byte scale prefix
        self._body = dim + 4 if dtype == "i8" else self.itemsize * dim
        self.points_dir = os.path.join(base_dir, "points")
        os.makedirs(self.points_dir, exist_ok=True)
        self.meta = MetadataLog(os.path.join(base_dir, "meta.log"))
        self._writers: dict[int, ArenaWriter] = {}
        self._readers: dict[int, ArenaReader] = {}
        self._dirty: set[int] = set()
        # Coarse store lock (reentrant): concurrent background re-encryption
        # updates the (key_version, arena_off) metadata pair non-atomically
        # with respect to candidate gathers — the reference serializes with
        # synchronized blocks (RocksDBMetadataManager.java:162,295,311,342)
        # and so do we.  Held per batch; contention cost is negligible.
        self._lock = threading.RLock()
        self._gc_stale_arenas()
        # order: the length check first so a legacy (marker-less) store
        # misdeclared to a different-length dtype fails BEFORE the marker
        # adopts the wrong dtype; the marker then catches the length-colliding
        # cases the geometry check cannot (see _check_dtype_marker)
        self._validate_payload_geometry()
        self._check_dtype_marker()

    # -- plumbing --------------------------------------------------------------

    def _arena_path(self, kv: int) -> str:
        """Current arena file for a key version.  Compaction bumps the
        version's epoch (committed in the metadata log), so the path is a
        function of durable metadata — a crash on either side of a
        compaction resolves to a consistent (file, offsets) pair."""
        epoch = self.meta.arena_epoch(kv)
        name = f"v{kv}.arena" if epoch == 0 else f"v{kv}.e{epoch}.arena"
        return os.path.join(self.points_dir, name)

    def _gc_stale_arenas(self) -> None:
        """Remove arena files whose epoch is not the metadata's current one —
        leftovers of a compaction interrupted before (new-epoch file) or
        after (old-epoch file) its commit record."""
        for name in os.listdir(self.points_dir):
            parsed = _parse_arena_name(name)
            if parsed is None:
                continue
            kv, epoch = parsed
            if epoch != self.meta.arena_epoch(kv):
                secure_delete_arena(os.path.join(self.points_dir, name))

    def _writer(self, kv: int) -> ArenaWriter:
        w = self._writers.get(kv)
        if w is None:
            w = ArenaWriter(self._arena_path(kv))
            self._writers[kv] = w
        return w

    def _reader(self, kv: int) -> ArenaReader:
        if kv in self._dirty:
            self._writers[kv].flush()
            self._dirty.discard(kv)
            r = self._readers.pop(kv, None)
            if r is not None:
                r.close()
        r = self._readers.get(kv)
        path = self._arena_path(kv)
        if r is None or r.size != os.path.getsize(path):
            if r is not None:
                r.close()
            r = ArenaReader(path)
            self._readers[kv] = r
        return r

    @property
    def record_ct_len(self) -> int:
        return self._body + TAG_LEN

    def _quantize_i8(self, vecs: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Symmetric per-row int8 quantization: scale = max|v|/127 so the
        row maximum maps to ±127 exactly — which makes re-quantization of a
        dequantized row IDEMPOTENT (re-encryption sweeps do decrypt →
        re-insert and must not drift).  Returns (scales f32 [n], q int8
        [n, dim])."""
        vecs = np.asarray(vecs, np.float32)
        amax = np.abs(vecs).max(axis=1)
        scales = (amax / np.float32(127.0)).astype(np.float32)
        safe = np.where(scales > 0, scales, np.float32(1.0))
        q = np.clip(np.rint(vecs / safe[:, None]), -127, 127).astype(np.int8)
        return scales, q

    def _check_dtype_marker(self) -> None:
        """Persist the storage dtype explicitly (``points/storage_dtype``)
        and compare at open time.  The record-length check below cannot
        distinguish dtypes whose serialized bodies collide (f16 at dim=4 is
        2*4 = 8 bytes, i8 is 4+4 = 8 bytes — GCM opens succeed either way
        because key/IV/AAD are identical, so a misdeclared reopen would
        silently decode the first 4 f16 bytes as the i8 scale).  The marker
        is authoritative; legacy stores without one adopt the configured
        dtype after the geometry check passes (trust-on-first-open)."""
        marker = os.path.join(self.points_dir, "storage_dtype")
        if os.path.exists(marker):
            with open(marker) as f:
                written = f.read().strip()
            if written and written != self.dtype:
                raise ValueError(
                    f"store was built with storage dtype {written!r} but is "
                    f"being opened as {self.dtype!r} — reopen with the dtype "
                    f"it was built with")
            return
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.dtype + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, marker)

    def _validate_payload_geometry(self) -> None:
        """An arena's record length is a function of the storage dtype it
        was written under; opening it under a different dtype would read
        every GCM tag at the wrong offset and fail each open SILENTLY
        (ok=False rows ⇒ garbage search results with no error anywhere).
        Check one existing record at open time and fail loudly instead."""
        live = self.meta.first_record()
        if live is None:
            return
        pid, kv, off = live
        try:
            _, _, _, _, ct = self._reader(kv).read_record(off)
        except (OSError, ValueError):
            return  # missing/torn arenas are the audit/rebuild paths' job
        if len(ct) != self.record_ct_len:
            raise ValueError(
                f"storage dtype {self.dtype!r} expects "
                f"{self.record_ct_len}-byte records but arena v{kv} holds "
                f"{len(ct)}-byte records (point {pid}) — the store was "
                f"written under a different storage dtype; reopen with the "
                f"dtype it was built with")

    def quantize(self, vecs: np.ndarray) -> np.ndarray:
        """Round-trip vectors through the storage dtype (so routing codes
        computed at build time match what restore will decode)."""
        if self.dtype == "f32":
            return np.asarray(vecs, np.float32)
        if self.dtype == "f16":
            return np.asarray(vecs, np.float32).astype("<f2").astype(
                np.float32)
        scales, q = self._quantize_i8(vecs)
        # f32 multiply, same order as the C dequant loop (s * (float)q)
        return scales[:, None] * q.astype(np.float32)

    def quantize_parts(self, vecs: np.ndarray
                       ) -> tuple[np.ndarray, tuple | None]:
        """``quantize()`` plus the i8 (scales, q) pair so a following
        ``insert_batch(prequant=...)`` skips re-quantizing — build ingest
        quantizes for routing consistency anyway, and a second abs/max/rint
        pass over every inserted batch is real money on a bandwidth-starved
        host.  parts is None for f32/f16 (their round trip is a cast)."""
        if self.dtype != "i8":
            return self.quantize(vecs), None
        scales, q = self._quantize_i8(vecs)
        return scales[:, None] * q.astype(np.float32), (scales, q)

    # -- writes ----------------------------------------------------------------

    @_locked
    def insert_batch(self, ids: np.ndarray, vecs: np.ndarray,
                     key_version: int | None = None,
                     prequant: tuple | None = None) -> None:
        """Encrypt + persist a batch under one key version (default: current).

        ``prequant`` (i8 stores only): the (scales, q) pair from
        ``quantize_parts`` — callers that already quantized for routing
        pass it to skip the redundant second quantization pass.  ``vecs``
        must be the matching dequantized preview (it is not re-checked).

        Write order is arena-append → arena fsync → metadata append → fsync:
        the metadata record is the commit point (reference's crash-consistent
        protocol, RocksDBMetadataManager.java:342-375, restructured for
        batches).
        """
        kv = self.km.current_version if key_version is None else key_version
        ids = np.asarray(ids)
        vecs = np.asarray(vecs, np.float32)
        n = len(ids)
        if vecs.shape != (n, self.dim):
            raise ValueError(f"expected vecs [{n}, {self.dim}], got {vecs.shape}")

        body = self._body
        with span("store.seal"):
            if self.dtype == "i8":
                if prequant is not None:
                    scales, qrows = prequant
                    if len(scales) != n or qrows.shape != (n, self.dim):
                        raise ValueError("prequant shapes disagree with vecs")
                else:
                    scales, qrows = self._quantize_i8(vecs)
                payload = np.empty((n, body), np.uint8)
                payload[:, :4] = scales.astype("<f4").view(np.uint8).reshape(
                    n, 4)
                payload[:, 4:] = qrows.view(np.uint8)
                pt = payload.reshape(-1)
            else:
                pt = np.frombuffer(vecs.astype(self.np_dtype).tobytes(),
                                   np.uint8).copy()
            lens = np.full(n, body, np.uint64)
            offs = np.arange(n, dtype=np.uint64) * body
            ivs = np.frombuffer(secrets.token_bytes(12 * n), np.uint8
                                ).reshape(n, 12).copy()
            aads = aad_batch(ids, kv, self.dim)
            ct, tags = aesgcm.seal_batch(self.km.gcm_for(kv), ivs, aads, pt,
                                         offs, lens)

        with span("store.persist"):
            w = self._writer(kv)
            clen = body
            ct_tag = np.concatenate([ct.reshape(n, clen), tags], axis=1)
            arena_offs = w.append_batch(ids, kv, self.dim, ivs, ct_tag)
            w.flush()
            self._dirty.add(kv)
            self.meta.put_batch(ids, kv, self.dim, arena_offs)
            self.meta.flush()

    @_locked
    def delete(self, ids) -> None:
        for pid in np.atleast_1d(np.asarray(ids)):
            self.meta.tombstone(int(pid))
        self.meta.flush()

    @_locked
    def undelete(self, ids) -> list[int]:
        """Clear tombstones (deletion is logical until the arena compacts or
        retires).  Ids whose backing ciphertext or key no longer exists —
        arena retired/compacted away, key version securely deleted — are
        SKIPPED (tombstone left in place): flipping them live would bind
        metadata to bytes that are gone and corrupt the version's retirement
        count.  Returns the ids actually restored."""
        restored: list[int] = []
        for pid in np.atleast_1d(np.asarray(ids)):
            pid = int(pid)
            kv = self.meta.tombstoned_version(pid)
            if kv is None:
                continue
            try:
                self.km.gcm_for(kv)
            except KeyError:
                continue              # key securely deleted
            if not os.path.exists(self._arena_path(kv)):
                continue              # arena retired
            self.meta.undelete(pid)
            restored.append(pid)
        self.meta.flush()
        return restored

    # -- reads -----------------------------------------------------------------

    @_locked
    def load_decrypt_batch(self, ids: np.ndarray,
                           out: np.ndarray | None = None,
                           norms_out: np.ndarray | None = None,
                           rows: np.ndarray | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Load + decrypt candidates.  ids int [n]; pad/missing/tombstoned
        entries yield ok=False.  Returns (vecs f32 [n, dim], ok bool [n]).

        ``out`` (f32 [>=n, dim], C-contiguous) reuses a caller-owned staging
        buffer: rows with ok=False then hold STALE bytes from earlier calls
        instead of zeros — only for hot-path callers that mask by ``ok``
        (page-faulting 100s of MB of fresh calloc per batch measurably beats
        the AES on this host).

        ``norms_out`` (f32 [n]) receives each row's squared L2 norm,
        computed in the C open loop while the row is in L1 for every
        storage dtype (f16 fuses it into the widen pass, i8 into the
        dequant as s²·Σq²).  Failed-tag rows write 0.0; rows that never
        reach the open (absent/tombstoned/out-of-bounds) leave their slot
        untouched — mask by ``ok`` before use.

        ``rows`` (int [n], requires ``out``) scatters result row i into
        ``out[rows[i]]`` instead of ``out[i]`` — the sharded store decrypts
        every shard's subset straight into ONE caller-owned staging matrix
        with no per-shard intermediate copies (norms land at the same
        scattered slots).  The returned ``ok`` stays indexed by input
        position.

        The port's own: one native pass over the whole set on the host's
        cores (:meth:`_open_records`) — the metadata lookup, the bounds
        guard and the multi-key GCM open (per-record key versions —
        reference QueryServiceImpl.java:250-251); the JAX package's method,
        one C call per key version, is its reference."""
        ids = np.ascontiguousarray(ids, np.int64)
        n = len(ids)
        if rows is not None:
            rows = np.ascontiguousarray(rows, np.int64)
            if out is None:
                raise ValueError("rows= requires a caller-owned out= buffer")
            if len(rows) != n:
                raise ValueError("rows/ids length mismatch")
            if rows.min(initial=0) < 0:
                raise ValueError("rows must be >= 0")
        need = (int(rows.max(initial=-1)) + 1) if rows is not None else n
        if out is not None:
            if out.ndim != 2 or out.shape[1] != self.dim \
                    or out.shape[0] < need or out.dtype != np.float32 \
                    or not out.flags.c_contiguous:
                raise ValueError("out must be C-contiguous f32 [>=n, dim]")
            vecs = out
        else:
            vecs = np.zeros((n, self.dim), np.float32)
        if norms_out is not None and (
                norms_out.dtype != np.float32 or len(norms_out) < need
                or not norms_out.flags.c_contiguous):
            raise ValueError("norms_out must be contiguous f32 [>=n]")
        return vecs, self._open_records(ids, rows, vecs, norms_out, None,
                                        None, 1)

    @_locked
    def load_score_batch(self, ids: np.ndarray, qvecs: np.ndarray,
                         rows_per_query: int, norms_out: np.ndarray,
                         dots_out: np.ndarray,
                         rows: np.ndarray | None = None) -> np.ndarray:
        """Fused decrypt-and-score (serving stage B fast path): decrypt each
        candidate into an L1 scratch row and emit only its squared L2 norm
        and its dot product against ``qvecs[i // rows_per_query]`` — the
        plaintext never touches DRAM, removing both full candidate-matrix
        passes (staging write + score re-read) of
        :meth:`load_decrypt_batch` + einsum.  Returns ok bool [n]; slots
        with ok=False hold zeros in ``norms_out``/``dots_out``.

        ``rows`` (int [n]) scatters result i's norm/dot to slot ``rows[i]``
        instead of ``i`` — the query-row mapping uses the SCATTERED slot
        (query = rows[i] // rows_per_query), so a sharded store fans its
        shards' subsets into one caller-owned (norms, dots) pair exactly
        like :meth:`load_decrypt_batch`'s scattered staging.

        The same native pass as :meth:`load_decrypt_batch`, AADs
        synthesized in-loop."""
        ids = np.ascontiguousarray(ids, np.int64)
        n = len(ids)
        if rows is not None:
            rows = np.ascontiguousarray(rows, np.int64)
            if len(rows) != n:
                raise ValueError("rows/ids length mismatch")
            if rows.min(initial=0) < 0:
                raise ValueError("rows must be >= 0")
        if norms_out.dtype != np.float32 or dots_out.dtype != np.float32:
            raise ValueError("norms_out/dots_out must be f32")
        need = (int(rows.max(initial=-1)) + 1) if rows is not None else n
        if len(norms_out) < need or len(dots_out) < need:
            raise ValueError("norms_out/dots_out too short")
        if not (norms_out.flags.c_contiguous and dots_out.flags.c_contiguous):
            raise ValueError("norms_out/dots_out must be contiguous")
        qvecs = np.asarray(qvecs)
        if rows_per_query < 1:
            raise ValueError("rows_per_query must be >= 1")
        if qvecs.ndim != 2 or qvecs.shape[1] != self.dim:
            raise ValueError("qvecs must be [n_queries, dim]")
        # the C loop indexes qvecs[slot // rows_per_query] with no bounds
        # check — validate here so an inconsistent caller fails loudly
        # instead of reading past the query matrix
        if len(qvecs) * rows_per_query < need:
            raise ValueError("qvecs rows cover fewer slots than needed")
        return self._open_records(ids, rows, None, norms_out, dots_out,
                                  np.ascontiguousarray(qvecs, np.float32),
                                  rows_per_query)

    def _open_records(self, ids, rows, pt, norms, dots, qvecs,
                      rows_per_query) -> np.ndarray:
        """The read of :meth:`load_decrypt_batch` (``pt`` given) or
        :meth:`load_score_batch`, checked by them, under the store lock:
        each key version's expanded key and arena as mapped now, then one
        pass of ``csrc/native/open_pool.c`` over every candidate.  Returns
        ok bool [n]."""
        with span("store.lookup"):
            versions = sorted(self.meta.live_versions())
            table = np.zeros((3, versions[-1] + 1 if versions else 1),
                             np.uint64)
            # the keys and arenas stay referenced until the pass ends
            held, broken = [], {}
            for v in versions:
                try:
                    reader, key = self._reader(v), self.km.gcm_for(v)
                except (OSError, KeyError) as e:
                    broken[v] = e       # an error only for its own records
                    continue
                held.append((reader, key))
                table[:, v] = (ctypes.addressof(key._ctx),
                               reader._buf.ctypes.data, reader.size)
            if broken:
                kv_all, _ = self.meta.lookup_batch(ids)
                for v, e in broken.items():
                    if (kv_all == v).any():
                        raise e
        with span("store.open"):
            ok, workers, failed = parallel_read.open_records(
                ids, rows, self.meta._kv, self.meta._off, table, self._body,
                self.dim, self._payload_kind, pt, norms, dots, qvecs,
                rows_per_query)
        count("store.open.workers", workers)
        # every record that reached an open, its tag good or not
        count("store.open.bytes",
              (int(np.count_nonzero(ok)) + failed) * self.record_ct_len)
        return ok.view(bool)

    def key_version_of(self, pid: int) -> int | None:
        m = self.meta.get(int(pid))
        return None if m is None else m.key_version

    # -- re-encryption -----------------------------------------------------------

    @_locked
    def reencrypt_ids(self, ids, target_version: int | None = None
                      ) -> ReencryptReport:
        """Selective re-encryption: migrate the given ids to target_version
        (default current), skipping already-current points (reference
        KeyRotationServiceImpl.reencryptTouched:215-289)."""
        t0 = time.perf_counter()
        kv_target = (self.km.current_version if target_version is None
                     else target_version)
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        before = self.size_bytes()
        kv_all, _ = self.meta.lookup_batch(ids)
        todo = ids[(kv_all > 0) & (kv_all < kv_target)]
        skipped = int((kv_all >= kv_target).sum())
        failed = 0
        if len(todo):
            vecs, ok = self.load_decrypt_batch(todo)
            good = np.flatnonzero(ok)
            failed = len(todo) - len(good)
            if len(good):
                self.insert_batch(todo[good], vecs[good], kv_target)
        after = self.size_bytes()
        return ReencryptReport(
            touched=len(ids), reencrypted=len(todo) - failed,
            skipped_current=skipped, failed=failed,
            time_ms=(time.perf_counter() - t0) * 1e3,
            bytes_delta=after - before, bytes_after=after)

    def reencrypt_all(self, target_version: int | None = None
                      ) -> ReencryptReport:
        """Full migration sweep (reference reEncryptAll:98-146)."""
        return self.reencrypt_ids(self.meta.live_ids(), target_version)

    # -- maintenance --------------------------------------------------------------

    @_locked
    def retire_version(self, kv: int) -> bool:
        """Securely delete an arena whose version no longer owns live points."""
        if self.meta.count_with_version(kv) > 0:
            return False
        r = self._readers.pop(kv, None)
        if r is not None:
            r.close()
        w = self._writers.pop(kv, None)
        if w is not None:
            w.close()
        secure_delete_arena(self._arena_path(kv))
        return True

    @_locked
    def audit_drift(self) -> dict:
        """Set-diff metadata ids vs arena records (reference auditDrift:649-689).

        ``meta_without_arena``: live metadata whose current-version arena
        record is missing/corrupt (data loss).  ``arena_garbage``: arena
        records no live metadata points at (superseded by re-encryption or
        tombstoned — reclaimable via compact_version)."""
        meta_ids = set(self.meta.live_ids().tolist())
        backed = set()
        garbage = 0
        for name in os.listdir(self.points_dir):
            parsed = _parse_arena_name(name)
            if parsed is None or parsed[1] != self.meta.arena_epoch(parsed[0]):
                continue
            kv = parsed[0]
            for off, pid, rkv, _dim, _iv, _ct in self._reader(kv).scan():
                m = self.meta.get(pid)
                if (m is not None and m.key_version == rkv
                        and m.arena_off == off):
                    backed.add(pid)
                else:
                    garbage += 1
        return {"meta_without_arena": sorted(meta_ids - backed),
                "arena_garbage_records": garbage,
                "meta_count": len(meta_ids)}

    @_locked
    def compact_version(self, kv: int) -> int:
        """Rewrite one live version's arena keeping only records current
        metadata points at (the reference queues superseded per-point files
        for deferred cleanup, RocksDBMetadataManager.java:430-498; with
        arenas, reclamation is a sequential rewrite).  Returns bytes freed.

        Crash-consistency protocol: the new arena is written under the NEXT
        epoch's filename and fsynced, then ONE metadata record commits the
        rewritten offsets and the epoch together; only then is the old
        epoch's file securely deleted.  A crash before the commit leaves the
        old (file, offsets) pair intact; after it, the new pair — stale
        files of either epoch are GC'd on reopen."""
        path = self._arena_path(kv)
        if not os.path.exists(path):
            return 0
        reader = self._reader(kv)
        before = reader.size
        new_epoch = self.meta.arena_epoch(kv) + 1
        new_path = os.path.join(self.points_dir, f"v{kv}.e{new_epoch}.arena")
        if os.path.exists(new_path):
            os.remove(new_path)
        w = ArenaWriter(new_path)
        pids: list[int] = []
        offs: list[int] = []
        for off, pid, rkv, dim, iv, ct in reader.scan():
            m = self.meta.get(pid)
            if m is not None and m.key_version == rkv and m.arena_off == off:
                new_off, _ = w.append(pid, rkv, dim, iv, ct)
                pids.append(pid)
                offs.append(new_off)
        w.close()   # fsync: the new arena is durable before its commit record
        # tombstoned ids bound to this version lose their ciphertext here —
        # purge them so a later undelete cannot resurrect a dangling offset
        for pid in self.meta.tombstoned_with_version(kv):
            self.meta.purge(int(pid))
        self.meta.commit_compaction(kv, self.dim,
                                    np.asarray(pids, np.int64),
                                    np.asarray(offs, np.int64), new_epoch)
        self.meta.flush()
        # the commit is durable — retire the old epoch's file
        r = self._readers.pop(kv, None)
        if r is not None:
            r.close()
        wr = self._writers.pop(kv, None)
        if wr is not None:
            wr.close()
        self._dirty.discard(kv)
        secure_delete_arena(path)
        return before - os.path.getsize(new_path)

    def restore_iter(self, batch: int = 4096):
        """Yield (ids int64 [b], vecs f32 [b, dim]) decrypting every live
        point — the index-rebuild path (reference restoreIndexFromDisk:926-948)."""
        live = np.sort(self.meta.live_ids().astype(np.int64))
        for s in range(0, len(live), batch):
            chunk = live[s:s + batch]
            vecs, ok = self.load_decrypt_batch(chunk)
            yield chunk[ok], vecs[ok]

    def size_bytes(self) -> int:
        total = 0
        for name in os.listdir(self.points_dir):
            total += os.path.getsize(os.path.join(self.points_dir, name))
        return total

    @_locked
    def flush(self) -> None:
        for kv, w in self._writers.items():
            w.flush()
        self.meta.flush()

    def close(self) -> None:
        self.flush()
        for r in self._readers.values():
            r.close()
        for w in self._writers.values():
            w.close()
        self.meta.close()
