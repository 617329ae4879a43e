"""Partitioned routing index: staging → device build → frozen query state.

Reference counterpart: ``index/paper/PartitionedIndexService.java`` —
buffers an initialization sample (:50-51, :280-290), stages per-point codes
(:314-347), ``finalizeForSearch`` builds greedy partitions and freezes
(:789-845), query-side candidate lookup (:592-715), tombstone filtering
(:726-753), probe overrides (:868-888).

Port of ``fspann_tpu/index/service.py``.  Ingestion encodes each batch as it
arrives (on the host with ``encode_backend="cpu"``, else on the index
device) and stages packed codes + keys in host arrays; ``finalize`` builds
the partition table (numpy on the host then one upload, or batched sorts on
the device) and, by mode, the device state stage A reads:

* ``routing_mode="probe"``: the table, plus every point's packed codes
  when ``rerank_limit > 0`` (the full-code re-rank, ``ops/code_hamming``);
* ``routing_mode="scan"``: the Hamming scan state, unpacked (int8 bit
  matrix) or packed (int32 words, ``runtime.scan_packed``), padded to
  ``runtime.scan_capacity_rows``; or none at all when the native host
  kernel serves stage A (``runtime.scan_native``) from the packed codes.
  The table is built too, for the checkpoint.

After finalize, ``append_rows`` (scan mode) inserts live: new rows fill the
capacity padding in place, or grow the state past it; on the host they are
written into the spare rows of the code and row-id buffers, which regrow
geometrically; the table goes stale.
``save_table`` / ``load_table`` read and write the JAX package's
``table.npz`` format.

This module holds NO cipher state — routing–ciphertext orthogonality is a
structural property here, not a convention: the class cannot see keys or
ciphertexts at all.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import SystemConfig
from ..ops import coding, hamming_scan, native_scan, partition, routing
from ..ops.partition import PartitionTable
from ..store import parallel_read
from ..utils import profiler
from ..utils.profiler import span


class IndexNotFinalized(RuntimeError):
    pass


def _consume_concat(chunks: list[np.ndarray]) -> np.ndarray:
    """Concatenate DESTRUCTIVELY: chunks are freed as they are copied, so
    peak memory is total + one chunk instead of 2x total."""
    if len(chunks) == 1:
        return chunks.pop()
    n = sum(len(c) for c in chunks)
    out = np.empty((n,) + chunks[0].shape[1:], chunks[0].dtype)
    off = 0
    while chunks:
        c = chunks.pop(0)
        out[off:off + len(c)] = c
        off += len(c)
    return out


# fewest spare rows a live insert's regrowth reserves, on the device (when
# capacity-padded) and on the host; above 8x this many rows, an eighth
GROW_MIN_ROWS = 4096


def _headroom(n: int) -> int:
    return max(n // 8, GROW_MIN_ROWS)


def _append_into(buf: np.ndarray | None, view: np.ndarray,
                 new: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(buffer, ``buffer[:len(view) + len(new)]``, bytes copied): ``new``
    written after ``view``'s rows into ``buf``'s spare rows when ``view``
    is its prefix and they suffice, else into a fresh buffer with
    ``_headroom`` spare rows, where the prefix is copied once.  No row of
    ``view`` is written, so a view taken earlier keeps its rows."""
    n, k = len(view), len(new)
    grown = 0
    if buf is None or view.base is not buf or n + k > len(buf):
        buf = np.empty((n + k + _headroom(n),) + view.shape[1:], view.dtype)
        buf[:n] = view
        grown = view.nbytes
    buf[n:n + k] = new
    return buf, buf[:n + k], grown


class PartitionedIndex:
    SAMPLE_THRESHOLD = 1000   # reference PartitionedIndexService.java:50-51

    def __init__(self, cfg: SystemConfig, dim: int,
                 bank_path: str | None = None,
                 table_path: str | None = None, device=None):
        self.cfg = cfg
        self.dim = dim
        self.bank_path = bank_path
        self.table_path = table_path
        self.device = resolve_device(device)
        self.bank: coding.GBank | None = None
        self._bank_dev: coding.GBank | None = None   # lazy device copy
        self._bank_cpu: coding.GBank | None = None   # lazy numpy copy
        self.frozen = False
        self.table: PartitionTable | None = None     # tensors on self.device
        # host (numpy) twins of the frozen table and of the probe-mode
        # re-rank codes: save_table writes from these without a device read
        self._table_host: PartitionTable | None = None
        self._codes_host: np.ndarray | None = None
        # int32 [N, G, W] code bit patterns on self.device, only when
        # runtime.rerank_limit > 0 in probe mode (G*W words per point)
        self.point_codes: torch.Tensor | None = None
        # scan state (routing_mode == "scan"; None when the native host
        # kernel serves) and the packed codes it came from (persisted by
        # save_table, extended by append_rows)
        self._scan_state: hamming_scan.ScanState | \
            hamming_scan.PackedScanState | None = None
        self._scan_codes: np.ndarray | None = None
        # the buffers append_rows writes into: _scan_codes and _row_ids are
        # their exact-length prefixes once a live insert has run
        self._codes_buf: np.ndarray | None = None
        self._ids_buf: np.ndarray | None = None
        # set by append_rows: the frozen partition table no longer covers
        # all rows; the probe path refuses to route until re-finalized
        self._table_stale = False
        self._scan_budget_cache: int | None = None
        # staging
        self._pending_vecs: list[np.ndarray] = []   # pre-bank raw vectors
        self._pending_ids: list[np.ndarray] = []
        self._codes: list[np.ndarray] = []          # [b, G, W] uint32
        self._keys: list[np.ndarray] = []           # [b, G] int64
        self._ids: list[np.ndarray] = []
        self._staged = 0
        self._deleted: set[int] = set()
        self._tombstones_np = None
        self._tombstones_dev = None
        self._tombstones_dirty = True
        # device scan-state row count (== _n_rows unless capacity-padded;
        # runtime.scan_capacity_rows) + its padded device tombstones
        self._scan_rows = 0
        self._tombstones_scan_dev = None
        if bank_path and os.path.exists(bank_path):
            self._load_bank(bank_path)

    # -- bank lifecycle ---------------------------------------------------------

    def _init_bank(self, sample: np.ndarray) -> None:
        pp = self.cfg.paper
        self.set_bank(coding.build_bank_from_sample(
            sample, pp.m, pp.lam, pp.tables, pp.divisions, pp.seed,
            pp.omega_divisor))

    def set_bank(self, bank: coding.GBank) -> None:
        """Install ``bank`` (built here, or carried across from the JAX
        package by ``api.convert.bank_from_jax``) before any row is
        staged; persisted to ``bank_path``."""
        pp = self.cfg.paper
        if (bank.m, bank.lam, bank.tables, bank.divisions, bank.d) != \
                (pp.m, pp.lam, pp.tables, pp.divisions, self.dim):
            raise ValueError("bank hyperparams do not match config/dim")
        if self._staged:
            raise RuntimeError("bank must be installed before staging rows")
        self.bank = bank
        self._bank_cpu = self._bank_dev = None
        if self.bank_path:
            self._save_bank(self.bank_path)

    def _save_bank(self, path: str) -> None:
        """Persist the bank with (omega, r) stats + hyperparams, and
        ``alpha``, which the JAX package's file leaves out (it regenerates
        ``alpha`` from the seed); the port reads both kinds of file."""
        b = self.bank
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        np.savez(tmp, alpha=np.asarray(b.alpha), omega=np.asarray(b.omega),
                 r=np.asarray(b.r), m=b.m, lam=b.lam, tables=b.tables,
                 divisions=b.divisions, seed=b.seed, dim=self.dim)
        os.replace(tmp + ".npz", path)

    def _load_bank(self, path: str) -> None:
        z = np.load(path)
        if int(z["dim"]) != self.dim:
            raise ValueError(f"bank dim {int(z['dim'])} != index dim {self.dim}")
        pp = self.cfg.paper
        if (int(z["m"]), int(z["lam"]), int(z["tables"]),
                int(z["divisions"])) != (pp.m, pp.lam, pp.tables, pp.divisions):
            # reference hard-asserts registry↔config match (index:809-817)
            raise ValueError("persisted bank hyperparams do not match config")
        if "alpha" in z.files:
            self.bank = coding.GBank(
                z["alpha"].astype(np.float32), z["r"].astype(np.float32),
                z["omega"].astype(np.float32), pp.m, pp.lam, pp.tables,
                pp.divisions, int(z["seed"]))
        else:
            # the JAX package's file: alpha regenerates from the seed, bit
            # for bit (its threefry stream, ops/threefry.py)
            self.bank = coding.bank_from_stats(
                z["omega"], z["r"], self.dim, pp.m, pp.lam, pp.tables,
                pp.divisions, int(z["seed"]))
        self._bank_cpu = self._bank_dev = None

    def _dev_bank(self) -> coding.GBank:
        """The bank on ``self.device``, moved once (``alpha`` is [G, m, d])
        for the device encode path."""
        if self._bank_dev is None:
            self._bank_dev = coding.bank_to(self.bank, self.device)
        return self._bank_dev

    def _host_bank(self) -> coding.GBank:
        """The bank as float32 numpy arrays for the host encoder; a bank
        installed as tensors is copied to the host once."""
        if self._bank_cpu is None:
            b = self.bank
            self._bank_cpu = coding.GBank(
                *(v.cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v, np.float32)
                  for v in (b.alpha, b.r, b.omega)),
                b.m, b.lam, b.tables, b.divisions, b.seed)
        return self._bank_cpu

    # -- ingestion ----------------------------------------------------------------

    def stage(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Stage a batch for the next finalize.  Coding runs immediately once
        the bank exists (one batch per insert batch — replacing the
        reference's per-vector tables×divisions×m dot products,
        PartitionedIndexService.java:331-346)."""
        if self.frozen:
            raise RuntimeError("index is finalized; no further staging")
        ids = np.asarray(ids, np.int64)
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"expected [*, {self.dim}] vectors, "
                             f"got {vecs.shape}")
        if len(ids) != len(vecs):
            raise ValueError("ids/vecs length mismatch")
        if (ids < 0).any():
            raise ValueError("ids must be non-negative")
        if not np.isfinite(vecs).all():
            raise ValueError("vectors contain NaN/Inf")

        if self.bank is None:
            self._pending_ids.append(ids)
            self._pending_vecs.append(vecs)
            buffered = sum(len(v) for v in self._pending_vecs)
            if buffered >= self.SAMPLE_THRESHOLD:
                sample = np.concatenate(self._pending_vecs)
                self._init_bank(sample)
                self._encode_staged(np.concatenate(self._pending_ids), sample)
                self._pending_ids.clear()
                self._pending_vecs.clear()
            return
        self._encode_staged(ids, vecs)

    def _setup_width(self) -> int:
        """Host threads of the set-up's encode and table sorts."""
        n = self.cfg.runtime.setup_threads
        if n < 0:
            raise ValueError(f"setup_threads must be >= 0, got {n}")
        return n or parallel_read.default_width()

    def _encode(self, vecs: np.ndarray, width: int = 1
                ) -> tuple[np.ndarray, np.ndarray]:
        """(uint32 codes [n, G, W], int64 keys [n, G]) on the host, encoded
        by the configured backend: numpy BLAS (on ``width`` host threads),
        or the index device."""
        if self.cfg.runtime.encode_backend == "cpu":
            return coding.encode_numpy(vecs, self._host_bank(), width=width)
        codes, keys = coding.encode(
            torch.from_numpy(np.ascontiguousarray(vecs, np.float32))
            .to(self.device), self._dev_bank())
        return coding.words_to_numpy(codes), keys.cpu().numpy()

    def _encode_staged(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        with span("index.encode"):
            # the set-up's ingest: the host encode on the set-up's threads
            codes, keys = self._encode(vecs, self._setup_width())
        self._codes.append(codes)
        self._keys.append(keys)
        self._ids.append(ids)
        self._staged += len(ids)

    @property
    def staged_bytes(self) -> int:
        """Host memory held by the staging arrays (observability hook for
        ingestion backpressure at stretch scale)."""
        return sum(c.nbytes for c in self._codes) \
            + sum(k.nbytes for k in self._keys) \
            + sum(i.nbytes for i in self._ids)

    # -- finalize -------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finalize(self) -> None:
        """Flush pending staging, build the partition table and the mode's
        device state, freeze (reference finalizeForSearch:789-845).
        Idempotent once frozen."""
        if self.frozen:
            return
        if self._pending_vecs:   # corpus smaller than the sample threshold
            sample = np.concatenate(self._pending_vecs)
            if self.bank is None:
                self._init_bank(sample)
            self._encode_staged(np.concatenate(self._pending_ids), sample)
            self._pending_ids.clear()
            self._pending_vecs.clear()
        if self._staged == 0:
            raise RuntimeError("nothing staged; cannot finalize empty index")

        ids = _consume_concat(self._ids)
        codes = _consume_concat(self._codes)      # [N, G, W]
        keys = _consume_concat(self._keys)        # [N, G]
        if len(ids) > 1 and not np.all(ids[:-1] <= ids[1:]):
            # streaming ingestion stages ordinals already in order — skip
            # the gather (a full extra copy of [N, G, W]) when sorted
            order = np.argsort(ids, kind="stable")
            ids, codes, keys = ids[order], codes[order], keys[order]
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate ids staged")

        # Dense row space: routing returns row indices mapped back to ids.
        self._row_ids = ids.astype(np.int64)
        self._dense = bool(len(ids) and ids[0] == 0
                           and ids[-1] == len(ids) - 1)
        # per-phase wall clocks, synchronised on the device work
        rt = self.cfg.runtime
        self.finalize_sec: dict[str, float] = {}
        if rt.rerank_limit > 0 and rt.routing_mode != "scan":
            # probe-path re-rank only; the scan keeps unpacked bits instead
            t0 = time.perf_counter()
            self.point_codes = coding.words_to_torch(codes, self.device)
            self._sync()
            self._codes_host = codes
            self.finalize_sec["rerank_codes_upload"] = \
                time.perf_counter() - t0
        if rt.routing_mode == "scan":
            self._scan_codes = codes               # persisted by save_table
            # when the native host kernel serves stage A, a device scan
            # state would be dead weight: the kernel reads the packed codes
            t0 = time.perf_counter()
            if self._native_preferred():
                self._scan_state = None
            else:
                self._scan_state = self._make_scan_state(codes)
                self._sync()
            # the phase is named by the layout served: "bits" (the int8
            # bit matrix), "packed" (int32 words) or "native" (none)
            layout = "native" if self._scan_state is None else "packed" \
                if isinstance(self._scan_state, hamming_scan.PackedScanState) \
                else "bits"
            self.finalize_sec[f"scan_upload_{layout}"] = \
                time.perf_counter() - t0
        wide = self._wide_keys()
        t0 = time.perf_counter()
        with span("index.finalize.tables"):
            if rt.encode_backend == "cpu":
                # sort/build on the host too (numpy, on the set-up's
                # threads, over group-major views: nothing is copied
                # group-major), then ship the compact table to the device
                # in one transfer
                table = partition.build_partitions_numpy(
                    keys.T, np.transpose(codes, (1, 0, 2)), rt.block_size,
                    wide=wide, width=self._setup_width())
                self.finalize_sec["table_build"] = time.perf_counter() - t0
                self._table_host = table
                t0 = time.perf_counter()
                self.table = partition.table_to(table, self.device)
                self._sync()
                self.finalize_sec["table_upload"] = time.perf_counter() - t0
            else:
                # the codes cross to the device once; the re-rank copy is
                # reused
                codes_dev = self.point_codes if self.point_codes is not None \
                    else coding.words_to_torch(codes, self.device)
                self.table = partition.build_partitions(
                    torch.from_numpy(keys).to(self.device).T.contiguous(),
                    codes_dev.permute(1, 0, 2).contiguous(), rt.block_size,
                    wide=wide)
                del codes_dev
                self._sync()
                self.finalize_sec["table_build"] = time.perf_counter() - t0
        self._n_rows = len(ids)
        self._codes.clear(); self._keys.clear(); self._ids.clear()
        self.frozen = True
        self._tombstones_dirty = True
        if self.table_path:
            t0 = time.perf_counter()
            self.save_table(self.table_path)
            self.finalize_sec["save_table"] = time.perf_counter() - t0

    # -- live ingestion (scan mode) ---------------------------------------------------

    def append_rows(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Insert AFTER finalize — scan mode only (beyond the reference,
        whose index freezes at finalizeForSearch:842).  New code rows go
        into the scan state and are searchable immediately; no partition
        rebuild.  The frozen partition table goes stale, so the probe path
        refuses to route until the next full finalize/restore
        (``_table_stale``)."""
        if not self.frozen:
            raise RuntimeError("append_rows is for post-finalize inserts; "
                               "use stage() before finalize")
        rt = self.cfg.runtime
        if rt.routing_mode != "scan" \
                or (self._scan_state is None and self._scan_codes is None):
            raise RuntimeError("live insert requires routing_mode='scan'")
        with span("index.append.check"):
            ids = np.asarray(ids, np.int64)
            vecs = np.asarray(vecs, np.float32)
            if vecs.ndim != 2 or vecs.shape[1] != self.dim:
                raise ValueError(f"expected [*, {self.dim}] vectors")
            if len(ids) != len(vecs) or (ids < 0).any():
                raise ValueError("bad ids")
            if np.isin(ids, self._row_ids).any():
                raise ValueError("append_rows ids collide with existing rows")
            if not np.isfinite(vecs).all():
                raise ValueError("vectors contain NaN/Inf")

        with span("index.append.encode"):
            codes, _ = self._encode(vecs)
        st = self._scan_state
        if st is not None:
            with span("index.append.device"):
                packed = isinstance(st, hamming_scan.PackedScanState)
                new_bits = hamming_scan.unpack_bits_numpy(
                    codes, self.cfg.paper.code_bits)
                new_popc = torch.from_numpy(
                    new_bits.sum(axis=1, dtype=np.int32)).to(self.device)
                body = coding.words_to_torch(codes, self.device) if packed \
                    else torch.from_numpy(new_bits).to(self.device)
                rows = st.words if packed else st.bits
                lo = self._n_rows
                if lo + len(ids) > self._scan_rows:
                    # out of capacity padding: grow on the device — old
                    # rows, the new rows, then fresh zero padding with
                    # geometric headroom (amortised O(1) over an insert
                    # stream; only the new rows cross the host link).
                    # Exact-fit builds (scan_capacity_rows == 0) grow
                    # exactly.
                    grow = 0 if rt.scan_capacity_rows == 0 \
                        else _headroom(self._scan_rows)
                    rows = torch.cat([rows[:lo], body,
                                      body.new_zeros((grow,)
                                                     + body.shape[1:])])
                    popc = torch.cat([st.popc[:lo], new_popc,
                                      new_popc.new_zeros(grow)])
                    profiler.count("index.append.grow_bytes",
                                   rows.nbytes + popc.nbytes)
                    self._scan_rows = lo + len(ids) + grow
                    self._tombstones_scan_dev = None
                    self._scan_budget_cache = None   # free memory changed
                else:
                    # in-place fill of the tombstoned capacity padding: the
                    # state keeps its storage and shape
                    rows = hamming_scan.update_rows(rows, body, lo)
                    popc = hamming_scan.update_rows(st.popc, new_popc, lo)
                self._scan_state = type(st)(rows, popc)
        with span("index.append.host_copy"):
            # native-only serving: the packed codes ARE the scan state.
            # Only the new rows are written; the arrays regrow (amortised
            # O(rows) over an insert stream) when their spare rows run out
            self._codes_buf, self._scan_codes, grown = _append_into(
                self._codes_buf, self._scan_codes, codes)
            self._ids_buf, self._row_ids, grown_ids = _append_into(
                self._ids_buf, self._row_ids, ids)
            profiler.count("index.append.host_grow_bytes", grown + grown_ids)
        self._dense = bool(self._dense and len(ids)
                           and ids[0] == self._n_rows
                           and np.array_equal(
                               ids, np.arange(ids[0], ids[0] + len(ids))))
        self._n_rows += len(ids)
        self._table_stale = True
        self._tombstones_dirty = True

    # -- deletion ---------------------------------------------------------------------

    def mark_deleted(self, ids) -> None:
        for i in np.atleast_1d(np.asarray(ids)):
            self._deleted.add(int(i))
        self._tombstones_dirty = True

    def _tombstones_host(self) -> np.ndarray:
        """bool [N] dead mask, host-resident (native scan path)."""
        if self._tombstones_dirty or self._tombstones_np is None:
            with span("index.tombstones"):
                t = np.zeros(self._n_rows, bool)
                if self._deleted:
                    if self._dense:
                        dead = np.fromiter(
                            (i for i in self._deleted if i < self._n_rows),
                            np.int64)
                        t[dead] = True
                    else:
                        mask = np.isin(self._row_ids,
                                       np.fromiter(self._deleted, np.int64))
                        t[mask] = True
                self._tombstones_np = t
                self._tombstones_dev = None
                self._tombstones_scan_dev = None
                self._tombstones_dirty = False
        return self._tombstones_np

    def _tombstones(self) -> torch.Tensor:
        """bool [N] dead mask on the index device."""
        host = self._tombstones_host()
        if self._tombstones_dev is None:
            with span("index.tombstones"):
                self._tombstones_dev = torch.from_numpy(host).to(self.device)
        return self._tombstones_dev

    def _tombstones_scan(self) -> torch.Tensor:
        """Device tombstones sized to the scan state's row count: live rows
        carry the regular mask, capacity padding is permanently dead."""
        host = self._tombstones_host()
        if self._scan_rows <= len(host):
            return self._tombstones()
        if self._tombstones_scan_dev is None:
            with span("index.tombstones"):
                t = np.ones(self._scan_rows, bool)
                t[:len(host)] = host
                self._tombstones_scan_dev = torch.from_numpy(t).to(
                    self.device)
        return self._tombstones_scan_dev

    # -- query ------------------------------------------------------------------------

    def encode_queries(self, queries: np.ndarray):
        """(uint32 codes [Q, G, W], int64 keys [Q, G]) as numpy arrays.
        Queries must be coded on the same backend as the corpus — float32
        rounding differs across backends exactly at bucket boundaries."""
        if self.bank is None:
            raise IndexNotFinalized("bank not initialized")
        return self._encode(np.asarray(queries, np.float32))

    def route_batch(self, qcodes, qkeys, probes: int | None = None,
                    refinement_limit: int | None = None) -> routing.RouteResult:
        """Stage A for a query batch.  Returned ids are EXTERNAL point ids;
        on the dense path they stay on the index device (the query service
        copies them to the host asynchronously)."""
        if not self.frozen or self.table is None:
            raise IndexNotFinalized(
                "query before finalizeForSearch "
                "(reference PartitionedIndexService.java:461)")
        rt = self.cfg.runtime
        probes = probes or rt.effective_probes()
        limit = refinement_limit or rt.refinement_limit
        if rt.routing_mode == "scan" and (self._scan_state is not None
                                          or self._scan_codes is not None):
            # global fine ranking, probes are moot — the caller's
            # refinement_limit IS honored (it is the decrypt budget L; the
            # adaptive-retry pass widens it).
            scan_l = min(refinement_limit or rt.effective_refinement(),
                         self._n_rows)
            adaptive = dict(anchor=rt.adaptive_decrypt_anchor,
                            margin=rt.adaptive_decrypt_margin,
                            floor=rt.adaptive_decrypt_floor)
            if self._use_native_scan():
                # the native host kernel streams the packed words once;
                # bit-identical to the device scan, as numpy arrays
                dead = self._tombstones_host() if self._deleted else None
                with span("index.scan"):
                    res = native_scan.scan_topl(
                        self._scan_codes, self._host_words(qcodes), dead,
                        scan_l, **adaptive)
                return self._map_external(res)
            if self._scan_state is None:
                raise RuntimeError(
                    "index was finalized for native-only scan serving "
                    "(scan_native) but the native backend is now "
                    "unavailable — rebuild or restore with scan_native"
                    "='off'")
            with span("index.query_bits"):
                qbits = torch.from_numpy(hamming_scan.unpack_bits_numpy(
                    self._host_words(qcodes), self.cfg.paper.code_bits)
                ).to(self.device)
            dead = self._tombstones_scan()
            if isinstance(self._scan_state, hamming_scan.PackedScanState):
                # the packed state always goes through the chunked scan
                # (the per-chunk device unpack is the point of packing)
                with span("index.scan"):
                    res = hamming_scan.scan_chunked(
                        self._scan_state, qbits, dead, scan_l,
                        code_bits=self.cfg.paper.code_bits, **adaptive)
            else:
                # when the [Q, N] rank scratch outgrows the device budget,
                # switch to the chunked running-top-L variant
                flat_bytes = qbits.shape[0] * self._scan_rows * 12
                scan_fn = hamming_scan.scan \
                    if flat_bytes <= self._scan_flat_budget() \
                    else hamming_scan.scan_chunked
                with span("index.scan"):
                    res = scan_fn(self._scan_state, qbits, dead, scan_l,
                                  **adaptive)
        elif self._table_stale:
            raise RuntimeError(
                "partition table stale after live inserts — probe routing "
                "needs a rebuild; serve with routing_mode='scan'")
        else:
            with span("index.query_bits"):
                qc = coding.words_to_torch(self._host_words(qcodes),
                                           self.device)
                qk = torch.as_tensor(qkeys if isinstance(qkeys, torch.Tensor)
                                     else np.asarray(qkeys, np.int64),
                                     dtype=torch.int64).to(self.device)
            dead = self._tombstones()
            with span("index.route"):
                if self.point_codes is not None and rt.rerank_limit > 0:
                    # fused probe → dedup → fine score → top-k (the
                    # candidate pool is the full probed set; the decrypt
                    # set is the best rerank_limit by exact code Hamming)
                    res = routing.route_rerank(self.table, qc, qk, dead,
                                               self.point_codes, probes,
                                               rt.rerank_limit)
                else:
                    res = routing.route(self.table, qc, qk, dead, probes,
                                        limit)
        return self._map_external(res)

    @staticmethod
    def _host_words(qcodes) -> np.ndarray:
        """Query codes as uint32 numpy words (tokens carry numpy codes)."""
        if isinstance(qcodes, torch.Tensor):
            return coding.words_to_numpy(qcodes)
        return np.asarray(qcodes, np.uint32)

    def _map_external(self, res: routing.RouteResult) -> routing.RouteResult:
        """Row indices → external point ids (identity for dense builds;
        otherwise the result moves to the host as numpy)."""
        if self._dense:
            return res
        ids, scores, n_unique, n_raw, n_dec = (
            None if a is None else
            a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            for a in res)
        mapped = np.where(ids >= 0, self._row_ids[np.maximum(ids, 0)], -1)
        return routing.RouteResult(mapped, scores, n_unique, n_raw, n_dec)

    def _native_preferred(self) -> bool:
        """Decide (at build/restore time) whether the native host kernel
        will serve stage A: "on" demands it (raises if the library cannot
        build), "auto" picks it exactly when the scan device is the CPU,
        where the torch scan streams the 8×-unpacked bit matrix.  When
        preferred, no device scan state is built — the packed codes serve
        directly."""
        mode = self.cfg.runtime.scan_native
        if mode == "off":
            return False
        if mode == "on":
            if not native_scan.available():
                raise RuntimeError("scan_native='on' but the native scan "
                                   "library failed to build")
            return True
        return self.device.type == "cpu" and native_scan.available()

    def _use_native_scan(self) -> bool:
        """Serve this route through the native kernel?  True exactly when
        the build/restore decided native-only serving (no device scan
        state was built) or scan_native='on'."""
        if self.cfg.runtime.scan_native == "off" or self._scan_codes is None:
            if self.cfg.runtime.scan_native == "on" and self.frozen:
                raise RuntimeError("scan_native='on' needs the packed codes "
                                   "(scan mode keeps them; probe mode with "
                                   "rerank_limit=0 does not)")
            return False
        return self._scan_state is None or self._native_preferred()

    def _make_scan_state(self, codes: np.ndarray):
        """Build the scan state on ``self.device`` in the configured
        layout.  "auto" packs only when the unpacked int8 bit matrix would
        not fit the device budget — packed costs more scan traffic but 8×
        fewer resident bytes (ops/hamming_scan.PackedScanState).

        When ``runtime.scan_capacity_rows`` exceeds the row count the
        state is padded with zero rows up to capacity; padding rows are
        tombstoned (``_tombstones_scan``) so the scan never ranks them, and
        post-finalize ``append_rows`` fills them in place."""
        cb = self.cfg.paper.code_bits
        n = int(codes.shape[0])
        cap = max(n, self.cfg.runtime.scan_capacity_rows)
        if cap > n:
            codes = np.concatenate(
                [codes, np.zeros((cap - n,) + codes.shape[1:], codes.dtype)])
        self._scan_rows = cap
        self._tombstones_scan_dev = None
        mode = self.cfg.runtime.scan_packed
        if mode == "auto":
            bits_bytes = cap * self.cfg.paper.num_groups * cb
            mode = "on" if bits_bytes > self._scan_pack_budget() else "off"
        if mode == "on":
            return hamming_scan.build_scan_state_packed(codes, cb,
                                                        device=self.device)
        return hamming_scan.build_scan_state(codes, cb, device=self.device)

    def _scan_pack_budget(self) -> int:
        """Resident device budget for the unpacked bit matrix: 60% of the
        scan device's free memory, 4 GiB on the CPU."""
        from ..utils.devmem import free_memory_budget
        return free_memory_budget(6, 10, fallback=4 << 30,
                                  device=self.device)

    def _scan_flat_budget(self) -> int:
        """Bytes of [Q, N] rank scratch the flat scan may allocate before
        route_batch switches to the chunked running-top-L scan.  Config knob
        ``runtime.scan_flat_budget_mb``; 0 = auto — half the scan device's
        free memory (which already excludes the resident bit matrix),
        2 GiB on the CPU."""
        mb = self.cfg.runtime.scan_flat_budget_mb
        if mb > 0:
            return mb << 20
        if self._scan_budget_cache is None:
            from ..utils.devmem import free_memory_budget
            self._scan_budget_cache = free_memory_budget(
                1, 2, fallback=2 << 30, device=self.device)
        return self._scan_budget_cache

    @property
    def size(self) -> int:
        return (self._n_rows if self.frozen else self._staged) \
            - len(self._deleted)

    def max_route_id(self) -> int:
        """Largest id route_batch can return."""
        if not self.frozen:
            return -1
        if self._dense:
            return self._n_rows - 1
        return int(self._row_ids.max(initial=-1))

    def _wide_keys(self) -> bool:
        """Resolve ``runtime.wide_keys`` against this index's code width
        (ops/partition — full code-prefix order past the 63-bit key)."""
        return self.cfg.runtime.wide_keys_active(self.cfg.paper.code_bits)

    # -- table checkpoint ---------------------------------------------------------

    def save_table(self, path: str) -> None:
        """Persist the frozen partition table — the fast-restore path, in
        the JAX package's ``table.npz`` format (same keys and dtypes).  The
        reference rebuilds routing state by decrypting every ciphertext
        (restoreIndexFromDisk:926-948); the table is deterministic given the
        data, so persisting it skips that work.  Tagged with the config so a
        mismatched profile falls back to the rebuild path."""
        t = self._table_host if self._table_host is not None \
            else partition.table_to_numpy(self.table)
        pp = self.cfg.paper
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        extra = {}
        if self._scan_codes is not None:   # scan mode
            extra["point_codes"] = self._scan_codes
        elif self._codes_host is not None:
            extra["point_codes"] = self._codes_host
        elif self.point_codes is not None:
            extra["point_codes"] = coding.words_to_numpy(self.point_codes)
        if t.min_key2 is not None:
            extra["min_key2"] = np.asarray(t.min_key2)
            extra["max_key2"] = np.asarray(t.max_key2)
        np.savez(tmp,
                 min_key=np.asarray(t.min_key), max_key=np.asarray(t.max_key),
                 rep_codes=np.asarray(t.rep_codes), ids=np.asarray(t.ids),
                 counts=np.asarray(t.counts), row_ids=self._row_ids,
                 dense=self._dense, n_rows=self._n_rows, dim=self.dim,
                 m=pp.m, lam=pp.lam, tables=pp.tables,
                 divisions=pp.divisions, seed=pp.seed,
                 block=self.cfg.runtime.block_size,
                 table_stale=self._table_stale, **extra)
        os.replace(tmp + ".npz", path)

    def load_table(self, path: str, expect_rows: int | None = None) -> bool:
        """Fast restore: load a persisted table (the port's or the JAX
        package's).  Returns False (caller does the decrypt-and-rebuild)
        when config or corpus shape disagree."""
        if not os.path.exists(path) or self.bank is None:
            return False
        z = np.load(path)
        pp = self.cfg.paper
        if (int(z["dim"]), int(z["m"]), int(z["lam"]), int(z["tables"]),
                int(z["divisions"]), int(z["seed"]),
                int(z["block"])) != (self.dim, pp.m, pp.lam, pp.tables,
                                     pp.divisions, pp.seed,
                                     self.cfg.runtime.block_size):
            return False
        if expect_rows is not None and int(z["n_rows"]) != expect_rows:
            return False
        rt = self.cfg.runtime
        stale = bool(z["table_stale"]) if "table_stale" in z.files else False
        if stale and rt.routing_mode != "scan":
            return False   # probe restore needs the decrypt-and-rebuild path
        if rt.rerank_limit > 0 or rt.routing_mode == "scan":
            if "point_codes" not in z.files:
                return False   # checkpoint predates rerank/scan — rebuild
            codes = z["point_codes"].astype(np.uint32)
            if codes.shape != (int(z["n_rows"]), pp.num_groups,
                               pp.code_words):
                # truncated/mismatched checkpoint: take the
                # decrypt-and-rebuild path instead
                return False
            if rt.rerank_limit > 0 and rt.routing_mode != "scan":
                self.point_codes = coding.words_to_torch(codes, self.device)
                self._codes_host = codes
            if rt.routing_mode == "scan":
                self._scan_codes = codes
                self._scan_state = None if self._native_preferred() \
                    else self._make_scan_state(codes)
        saved_wide = "min_key2" in z.files
        if saved_wide != self._wide_keys():
            return False   # key-width mismatch: decrypt-and-rebuild
        table_np = PartitionTable(
            z["min_key"], z["max_key"], z["rep_codes"].astype(np.uint32),
            z["ids"].astype(np.int32), z["counts"].astype(np.int32),
            z["min_key2"] if saved_wide else None,
            z["max_key2"] if saved_wide else None)
        self._table_host = table_np
        self.table = partition.table_to(table_np, self.device)
        self._row_ids = z["row_ids"].astype(np.int64)
        self._dense = bool(z["dense"])
        self._n_rows = int(z["n_rows"])
        self.frozen = True
        self._table_stale = stale
        self._tombstones_dirty = True
        return True
