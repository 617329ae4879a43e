"""Scan-mode routing index: staging → device scan state → frozen query state.

Reference counterpart: ``index/paper/PartitionedIndexService.java`` —
buffers an initialization sample (:50-51, :280-290), stages per-point codes
(:314-347), ``finalizeForSearch`` freezes (:789-845), tombstone filtering
(:726-753).

This port serves stage A with the Hamming scan (``routing_mode="scan"``):
ingestion encodes on the host (``encode_backend="cpu"``) and stages packed
codes; ``finalize`` uploads them once and unpacks the int8 bit matrix on
the device.  No partition table is built — the scan never reads one.  Not
ported yet (each raises ``NotImplementedError`` where it would be chosen):
probe routing and its partition table, device encode, the packed scan
state, the native CPU scan, live insert (``append_rows``) and the table
checkpoint.

This module holds NO cipher state — routing–ciphertext orthogonality is a
structural property here, not a convention: the class cannot see keys or
ciphertexts at all.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import default_device
from ..config import SystemConfig
from ..ops import coding, hamming_scan, routing


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


def _check_ported(cfg: SystemConfig) -> None:
    rt = cfg.runtime
    if rt.routing_mode != "scan":
        raise NotImplementedError("the torch port serves routing_mode='scan'"
                                  " only; probe routing is not ported yet")
    if rt.encode_backend != "cpu":
        raise NotImplementedError("the torch port encodes on the host only "
                                  "(encode_backend='cpu')")
    if rt.refine_backend != "host":
        raise NotImplementedError("the torch port refines on the host only "
                                  "(refine_backend='host')")
    if rt.scan_native == "on":
        # "auto"/"off" serve from the torch scan on every device
        raise NotImplementedError("scan_native='on': the native CPU scan is "
                                  "not ported yet")
    if rt.scan_packed == "on":
        raise NotImplementedError("scan_packed='on': the packed scan state "
                                  "is not ported yet")


class PartitionedIndex:
    SAMPLE_THRESHOLD = 1000   # reference PartitionedIndexService.java:50-51

    def __init__(self, cfg: SystemConfig, dim: int,
                 bank_path: str | None = None,
                 table_path: str | None = None, device=None):
        _check_ported(cfg)
        self.cfg = cfg
        self.dim = dim
        self.bank_path = bank_path
        self.table_path = table_path
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.bank: coding.GBank | None = None
        self.frozen = False
        # unpacked int8 bit matrix + popcounts on self.device
        self._scan_state: hamming_scan.ScanState | None = None
        # live insert is not ported: the frozen state always covers all rows
        self._table_stale = False
        self._scan_budget_cache: int | None = None
        # staging
        self._pending_vecs: list[np.ndarray] = []   # pre-bank raw vectors
        self._pending_ids: list[np.ndarray] = []
        self._codes: list[np.ndarray] = []          # [b, G, W] uint32
        self._ids: list[np.ndarray] = []
        self._staged = 0
        self._deleted: set[int] = set()
        self._tombstones_np = None
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
        if self.bank_path:
            self._save_bank(self.bank_path)

    def _save_bank(self, path: str) -> None:
        """Persist the bank with (omega, r) stats + hyperparams.  ``alpha``
        is stored too: a bank carried across from the JAX package was not
        drawn from this package's generator, so the seed alone would not
        reproduce it."""
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
        if "alpha" not in z.files:
            # a JAX-package bank file: its alpha comes from threefry, which
            # this package cannot regenerate from the seed
            raise ValueError(f"{path} holds no alpha; carry a JAX bank "
                             f"across with api.convert.bank_from_jax")
        self.bank = coding.GBank(
            z["alpha"].astype(np.float32), z["r"].astype(np.float32),
            z["omega"].astype(np.float32), pp.m, pp.lam, pp.tables,
            pp.divisions, int(z["seed"]))

    # -- ingestion ----------------------------------------------------------------

    def stage(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Stage a batch for the next finalize.  Coding runs immediately once
        the bank exists (one host batch per insert batch — replacing the
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

    def _encode_staged(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        codes, _keys = coding.encode_numpy(vecs, self.bank)
        self._codes.append(codes)
        self._ids.append(ids)
        self._staged += len(ids)

    # -- finalize -------------------------------------------------------------------

    def finalize(self) -> None:
        """Flush pending staging, build the device scan state, freeze
        (reference finalizeForSearch:789-845).  Idempotent once frozen."""
        if self.frozen:
            return
        _check_ported(self.cfg)
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
        if len(ids) > 1 and not np.all(ids[:-1] <= ids[1:]):
            # streaming ingestion stages ordinals already in order — skip
            # the gather (a full extra copy of [N, G, W]) when sorted
            order = np.argsort(ids, kind="stable")
            ids, codes = ids[order], codes[order]
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate ids staged")

        # Dense row space: routing returns row indices mapped back to ids.
        self._row_ids = ids.astype(np.int64)
        self._dense = bool(len(ids) and ids[0] == 0
                           and ids[-1] == len(ids) - 1)
        # per-phase wall clocks, synchronised on the device work
        self.finalize_sec: dict[str, float] = {}
        t0 = time.perf_counter()
        self._scan_state = self._make_scan_state(codes)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.finalize_sec["scan_upload"] = time.perf_counter() - t0
        self._n_rows = len(ids)
        self._codes.clear(); self._ids.clear()
        self.frozen = True
        self._tombstones_dirty = True

    def append_rows(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        raise NotImplementedError("live insert is not ported yet")

    def load_table(self, path: str, expect_rows: int | None = None) -> bool:
        """No table checkpoint is written by this port yet: restore always
        takes the decrypt-and-rebuild path."""
        return False

    # -- deletion ---------------------------------------------------------------------

    def mark_deleted(self, ids) -> None:
        for i in np.atleast_1d(np.asarray(ids)):
            self._deleted.add(int(i))
        self._tombstones_dirty = True

    def _tombstones_host(self) -> np.ndarray:
        """bool [N] dead mask, host-resident."""
        if self._tombstones_dirty or self._tombstones_np is None:
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
            self._tombstones_scan_dev = None
            self._tombstones_dirty = False
        return self._tombstones_np

    def _tombstones_scan(self) -> torch.Tensor:
        """Device tombstones sized to the scan state's row count: live rows
        carry the regular mask, capacity padding is permanently dead."""
        host = self._tombstones_host()
        if self._tombstones_scan_dev is None:
            t = np.ones(self._scan_rows, bool)
            t[:len(host)] = host
            self._tombstones_scan_dev = torch.from_numpy(t).to(self.device)
        return self._tombstones_scan_dev

    # -- query ------------------------------------------------------------------------

    def encode_queries(self, queries: np.ndarray):
        if self.bank is None:
            raise IndexNotFinalized("bank not initialized")
        # queries must be coded on the same backend as the corpus — f32
        # matmul rounding differs across backends exactly at bucket
        # boundaries
        return coding.encode_numpy(np.asarray(queries, np.float32),
                                   self.bank)

    def route_batch(self, qcodes, qkeys, probes: int | None = None,
                    refinement_limit: int | None = None) -> routing.RouteResult:
        """Stage A for a query batch: the Hamming scan over every row.
        Returned ids are EXTERNAL point ids; on the dense path they stay on
        the scan device (the query service copies them to the host
        asynchronously)."""
        if not self.frozen or self._scan_state is None:
            raise IndexNotFinalized(
                "query before finalizeForSearch "
                "(reference PartitionedIndexService.java:461)")
        rt = self.cfg.runtime
        _check_ported(self.cfg)
        # global fine ranking, probes are moot — the caller's
        # refinement_limit IS honored (it is the decrypt budget L; the
        # adaptive-retry pass widens it).  When the [Q, N] rank scratch
        # outgrows the device budget, switch to the chunked running-top-L
        # variant.
        scan_l = min(refinement_limit or rt.effective_refinement(),
                     self._n_rows)
        qbits = torch.from_numpy(hamming_scan.unpack_bits_numpy(
            np.asarray(qcodes), self.cfg.paper.code_bits)).to(self.device)
        flat_bytes = qbits.shape[0] * self._scan_rows * 12
        scan_fn = hamming_scan.scan \
            if flat_bytes <= self._scan_flat_budget() \
            else hamming_scan.scan_chunked
        res = scan_fn(self._scan_state, qbits, self._tombstones_scan(),
                      scan_l, anchor=rt.adaptive_decrypt_anchor,
                      margin=rt.adaptive_decrypt_margin,
                      floor=rt.adaptive_decrypt_floor)
        return self._map_external(res)

    def _map_external(self, res: routing.RouteResult) -> routing.RouteResult:
        """Row indices → external point ids (identity for dense builds;
        otherwise the result moves to the host as numpy)."""
        if self._dense:
            return res
        rid = res.ids.cpu().numpy()
        mapped = np.where(rid >= 0, self._row_ids[np.maximum(rid, 0)], -1)
        return routing.RouteResult(mapped, res.scores.cpu().numpy(),
                                   res.n_unique.cpu().numpy(),
                                   res.n_raw.cpu().numpy(),
                                   None if res.n_dec is None
                                   else res.n_dec.cpu().numpy())

    def _make_scan_state(self, codes: np.ndarray) -> hamming_scan.ScanState:
        """Build the unpacked scan state on ``self.device``.

        When ``runtime.scan_capacity_rows`` exceeds the row count the
        state is padded with zero rows up to capacity; padding rows are
        tombstoned (``_tombstones_scan``) so the scan never ranks them."""
        cb = self.cfg.paper.code_bits
        n = int(codes.shape[0])
        cap = max(n, self.cfg.runtime.scan_capacity_rows)
        if cap > n:
            codes = np.concatenate(
                [codes, np.zeros((cap - n,) + codes.shape[1:], codes.dtype)])
        self._scan_rows = cap
        self._tombstones_scan_dev = None
        if self.cfg.runtime.scan_packed == "auto" and \
                cap * self.cfg.paper.num_groups * cb > self._scan_pack_budget():
            raise NotImplementedError(
                "the unpacked scan state does not fit the device budget and "
                "the packed scan state is not ported yet")
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
