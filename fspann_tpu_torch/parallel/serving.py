"""Distributed encrypted serving facade: sharded routing + sharded
ciphertext stores behind one object.  Port of
``fspann_tpu/parallel/serving.py``.

The single-device ``ForwardSecureANNSystem`` composes PartitionedIndex +
PointStore; this is its sharded counterpart: the device holds ONLY routing
state (per-shard partition tables or scan state — no vector content, same
routing–ciphertext orthogonality as the single-device design), the host
holds shard-aligned encrypted arenas (``ShardedPointStore``, range
placement matching the index's shards), and a query is:

  stage A  per-shard routing + merge (``ShardedIndex.route`` /
           ``scan_route`` — candidate ids only leave the devices; the merge
           runs where ``runtime.mesh_merge`` says: "ici" on the first
           card, after a peer-copy gather, "host" on the host)
  stage B  batched multi-key AES-GCM opens from the shard arenas
  stage C  exact L2 + top-k on the host (BLAS)

The reference has no distributed analogue (its only scale-out is N local
RocksDB shards, common/ShardedMetadataManager.java).  The scan route of
stage A passes no ``approx``, as the JAX facade does: each shard's top-L is
the approximate selection (``ops/approx_topk``, the TPU's ``approx_max_k``)
and the merge over the shards is exact.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import SystemConfig
from ..crypto.keys import KeyManager
from ..ops import coding
from ..query.service import _host_refine_scored
from ..store.sharded_store import ShardedPointStore
from .sharded import ShardedIndex, make_mesh, resolve_scan_layout


class DistributedEncryptedSystem:
    """Trusted-eval surface (queries in plaintext at the serving boundary,
    like the reference's server-side token decrypt); payloads encrypted at
    rest, forward-secure rotation via the shared keystore."""

    def __init__(self, cfg: SystemConfig, base_dir: str, dim: int,
                 mesh=None, key_manager: KeyManager | None = None,
                 device=None):
        """``mesh`` defaults to one shard on each visible CUDA card
        (``make_mesh()``, the JAX facade's mesh of every chip), or to the
        shards of one device when ``device`` names it
        (``make_mesh(device=device)``)."""
        self.cfg = cfg
        self.dim = dim
        self.base_dir = base_dir
        self.mesh = mesh or (make_mesh() if device is None
                             else make_mesh(device=device))
        self.ndev = self.mesh.n_shards
        os.makedirs(base_dir, exist_ok=True)
        self.km = key_manager if key_manager is not None else KeyManager(
            os.path.join(base_dir, "keystore.blob"),
            retention_max=cfg.keys.retention_max)
        self.store = ShardedPointStore(base_dir, self.km, dim,
                                       num_shards=self.ndev,
                                       placement="range",
                                       dtype=cfg.runtime.storage_dtype)
        # full rotation lifecycle over the sharded store — same service +
        # background daemon as the single-device facade (the sharded store's
        # meta view satisfies the same surface)
        from ..crypto.rotation import (BackgroundReencryption,
                                       KeyRotationService, RotationPolicy)
        self.rotation = KeyRotationService(
            self.km, self.store,
            RotationPolicy(cfg.keys.ops_threshold,
                           cfg.keys.age_threshold_ms))
        self.background = None
        if cfg.reencryption.background_enabled:
            self.background = BackgroundReencryption(
                self.rotation, cfg.reencryption.background_interval_s,
                cfg.reencryption.background_batch)
            self.background.start()
        self.index: ShardedIndex | None = None
        self.n = 0
        # reusable decrypt staging (grown on demand) — same fusion as the
        # single-device QueryService: no candidate-set-sized calloc per batch,
        # norms computed inside the C open loop
        self._norms_buf = np.zeros(0, np.float32)
        self._dots_buf = np.zeros(0, np.float32)

    # -- build -----------------------------------------------------------------

    def _scan_layout(self, shard_rows: int):
        """The configured scan-state layout (runtime.scan_packed →
        keep_bits value): False off scan mode; True unpacked; "packed" the
        word layout with 8× fewer resident bytes; auto packs when the rows
        of any one device (the shards of every slot it holds) would not
        fit its free memory unpacked."""
        rt = self.cfg.runtime
        if rt.routing_mode != "scan":
            return False
        pp = self.cfg.paper
        slot_rows = shard_rows * self.mesh.shards_per_slot
        # resolve_scan_layout understands "on"/"off"/"auto" verbatim
        layouts = [resolve_scan_layout(
            rt.scan_packed, slot_rows * self.mesh.slots.count(dev),
            pp.num_groups * pp.code_bits, device=dev)
            for dev in self.mesh.devices]
        return "packed" if "packed" in layouts else layouts[0]

    def build(self, base: np.ndarray, sample: int = 1000,
              capacity: int | None = None) -> None:
        """Encrypt + persist the corpus into shard-aligned arenas and build
        the mesh routing tables.  The plaintext is NOT kept on the device
        (keep_base=False).  ``capacity`` reserves live-insert headroom."""
        # quantize through the storage dtype FIRST so the routing state is
        # computed on exactly what a decrypt pass will decode (same
        # discipline as the single-device facade, api/system.py:110)
        base, parts = self.store.quantize_parts(np.asarray(base, np.float32))
        self.n = len(base)
        pp = self.cfg.paper
        bank = coding.build_bank_from_sample(
            base[:sample], pp.m, pp.lam, pp.tables, pp.divisions, pp.seed,
            pp.omega_divisor)
        self.index = ShardedIndex(
            self.mesh, bank, block_size=self.cfg.runtime.block_size,
            wide_keys=self.cfg.runtime.wide_keys_active(
                self.cfg.paper.code_bits))
        rt = self.cfg.runtime
        self.index.merge_backend = rt.mesh_merge
        rows = -(-max(self.n, capacity or 0) // self.ndev)
        self.index.build(base, keep_base=False,
                         keep_codes=(rt.rerank_limit > 0
                                     and rt.routing_mode != "scan"),
                         keep_bits=self._scan_layout(rows),
                         capacity=capacity)
        self.store.set_range_size(self.index.shard_rows)
        self.store.insert_batch(np.arange(self.n, dtype=np.int64), base,
                                prequant=parts)

    def insert_live(self, vecs: np.ndarray) -> np.ndarray:
        """Live insert at mesh scale (scan mode): the next global ordinals
        are assigned (range placement requires contiguity), the bit rows
        append on the owning shard devices, ciphertexts persist to the
        shard-aligned arenas, and the rows are searchable immediately —
        key rotation covers them like any other point.  Beyond the
        reference (whose index freezes at finalizeForSearch)."""
        if self.cfg.runtime.routing_mode != "scan":
            raise RuntimeError("mesh live insert requires "
                               "routing_mode='scan'")
        if self.index is None:
            raise RuntimeError("build() before insert_live")
        vecs, parts = self.store.quantize_parts(np.asarray(vecs, np.float32))
        ids = self.index.append_scan_rows(vecs)
        self.store.insert_batch(ids, vecs, prequant=parts)
        self.n = self.index.n
        return ids

    def index_stream(self, data, batch_size: int = 100_000,
                     n_total: int | None = None, sample: int = 1000,
                     capacity: int | None = None) -> int:
        """Streaming build — the large-corpus ingestion path (reference
        streaming loop, ForwardSecureANNSystem.java:438-479): consume the
        corpus batch-by-batch, encrypt+persist each batch into the
        shard-aligned arenas, and feed it to ``ShardedIndex.build_stream``
        — the corpus is NEVER materialized (host peak ≈ one batch + the
        bank sample; device peak = the shard's routing state).

        ``data``: ndarray / vecs-file path (n known), or any iterator of
        [b, d] chunks with ``n_total`` given.  Ids are stream ordinals.
        """
        from ..io import loaders

        if isinstance(data, str):
            data = loaders.load_vectors(data)
        if hasattr(data, "shape"):
            n_total = len(data) if n_total is None else min(n_total,
                                                            len(data))
            chunks = (b for _, b in loaders.stream_batches(
                data, batch_size, n_total))
        else:
            if n_total is None:
                raise ValueError("iterator input requires n_total")
            chunks = iter(data)
        if n_total <= 0:
            raise ValueError("empty stream")
        self.n = n_total
        pp = self.cfg.paper
        rt = self.cfg.runtime
        rows = -(-max(n_total, capacity or 0) // self.ndev)
        self.store.set_range_size(rows)

        # bank from the first `sample` buffered rows, then replay
        buf: list[np.ndarray] = []
        buffered = 0
        for c in chunks:
            buf.append(self.store.quantize(np.ascontiguousarray(
                c, np.float32)))
            buffered += len(buf[-1])
            if buffered >= min(sample, n_total):
                break
        if buffered == 0:
            raise ValueError("empty stream")
        sample_rows = np.concatenate(buf)[:sample] if len(buf) > 1 \
            else buf[0][:sample]
        bank = coding.build_bank_from_sample(
            sample_rows, pp.m, pp.lam, pp.tables, pp.divisions, pp.seed,
            pp.omega_divisor)
        self.index = ShardedIndex(
            self.mesh, bank, block_size=rt.block_size,
            wide_keys=rt.wide_keys_active(self.cfg.paper.code_bits))
        self.index.merge_backend = rt.mesh_merge

        def feed():
            import itertools
            pos = 0
            for c in itertools.chain(buf, chunks):
                # quantize is idempotent, so re-quantizing buffered
                # (already-quantized) chunks is exact
                c, parts = self.store.quantize_parts(np.ascontiguousarray(
                    c, np.float32))
                ids = np.arange(pos, pos + len(c), dtype=np.int64)
                # encrypt + persist (prequant: quantize once, not twice)
                self.store.insert_batch(ids, c, prequant=parts)
                pos += len(c)
                yield c

        total = self.index.build_stream(
            feed(), n_total,
            keep_codes=(rt.rerank_limit > 0 and rt.routing_mode != "scan"),
            keep_bits=self._scan_layout(rows), capacity=capacity)
        self.store.flush()
        return total

    # -- query -----------------------------------------------------------------

    def search_batch(self, queries: np.ndarray, k: int,
                     probe_shards: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (ids int64 [Q, K] with -1 pad, distances f32 [Q, K])."""
        return self.search_batches([queries], k, probe_shards)[0]

    def search_batches(self, batches, k: int,
                       probe_shards: int | None = None
                       ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Pipelined mesh serving (mirrors the single-device
        ``QueryService.search_batches``): the mesh routing step for batch
        i+1 is dispatched — with its D2H copies already started — before
        batch i's host decrypt+refine consumes its results, so device
        routing overlaps host AES across batches."""
        if self.index is None:
            raise RuntimeError("build() before search")
        results: list[tuple[np.ndarray, np.ndarray]] = []
        pending = None
        for q in list(batches) + [None]:
            current = None
            if q is not None:
                q = np.asarray(q, np.float32)
                current = (q, self._dispatch_route(q, probe_shards))
            if pending is not None:
                results.append(self._consume_batch(*pending, k=k,
                                                   probe_shards=probe_shards))
            pending = current
        return results

    def _dispatch_route(self, queries: np.ndarray,
                        probe_shards: int | None):
        """Stage-A dispatch: (ids, scores) queued on the device with their
        host copies in flight; the wait happens at consume time."""
        rt = self.cfg.runtime
        if rt.routing_mode == "scan":
            return self.index.scan_route_dispatch(
                queries, limit=rt.effective_refinement(),
                probe_shards=probe_shards)
        return self.index.route_dispatch(
            queries, probes=rt.effective_probes(),
            refinement_limit=rt.refinement_limit,
            probe_shards=probe_shards, rerank_limit=rt.rerank_limit)

    def _consume_batch(self, queries: np.ndarray, dispatched, k: int,
                       probe_shards: int | None
                       ) -> tuple[np.ndarray, np.ndarray]:
        rt = self.cfg.runtime
        cand_ids, _scores = dispatched.get()
        if rt.routing_mode == "scan":
            if rt.adaptive_decrypt_margin > 0:
                # adaptive per-query decrypt budget (mirrors the
                # single-device scan path, query/service.py): the merged
                # score matrix is already host-side, so the count is a
                # numpy one-liner — mask the non-competitive tail before
                # the sharded AES fan-out
                L = cand_ids.shape[1]
                a = max(min(rt.adaptive_decrypt_anchor, L), 1)
                pad = np.iinfo(np.int32).max
                s_a = np.minimum(_scores[:, a - 1],
                                 pad - rt.adaptive_decrypt_margin - 1)
                n_dec = (_scores <= (s_a + rt.adaptive_decrypt_margin)
                         [:, None]).sum(axis=1).astype(np.int32)
                # same lower clamp as ops.hamming_scan._adaptive_count:
                # max(floor, anchor), so mesh == single-device for every
                # (floor, anchor) combination
                floor = min(max(rt.adaptive_decrypt_floor, a), L)
                n_dec = np.clip(n_dec, floor, L)
                cand_ids = np.where(
                    np.arange(L)[None, :] < n_dec[:, None], cand_ids, -1)
        q, r = cand_ids.shape
        flat = cand_ids.reshape(-1).astype(np.int64)
        # fused decrypt-and-score (mirrors query/service.py): each shard's
        # C AES loop emits (norm, query-dot) while the row is in L1 — no
        # candidate matrix is ever materialized on the host
        if self._norms_buf.size < flat.size:
            self._norms_buf = np.zeros(flat.size, np.float32)
        if self._dots_buf.size < flat.size:
            self._dots_buf = np.zeros(flat.size, np.float32)
        norms = self._norms_buf[:flat.size]
        dots = self._dots_buf[:flat.size]
        ok = self.store.load_score_batch(flat, queries, r, norms, dots,
                                         probe_shards=probe_shards)
        return _host_refine_scored(queries, dots.reshape(q, r),
                                   norms.reshape(q, r),
                                   cand_ids.astype(np.int64),
                                   ok.reshape(q, r), k)[:2]

    # -- deletion ------------------------------------------------------------------

    def delete(self, ids) -> None:
        """Logical deletion at mesh scale: tombstone the shard arenas AND
        the device-side mask (a runtime input to every query step — no
        rebuild).  Mirrors the single-device
        ``ForwardSecureANNSystem.delete``."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        self.store.delete(ids)
        if self.index is not None:
            self.index.mark_deleted(ids)

    def undelete(self, ids) -> list[int]:
        """Reverse logical deletions (until the shard arenas compact or
        retire) — only ids whose ciphertext and key still exist come back;
        the device mask clears for exactly those."""
        restored = self.store.undelete(ids)
        if restored and self.index is not None:
            self.index.mark_undeleted(np.asarray(restored, np.int64))
        return restored

    # -- checkpoint / restore ------------------------------------------------------

    def save_index(self) -> str:
        """Persist the mesh routing state next to the shard arenas (the
        ciphertext stores persist themselves); returns the checkpoint
        path."""
        if self.index is None:
            raise RuntimeError("nothing to save")
        path = os.path.join(self.base_dir, "mesh_state.npz")
        self.index.save_state(path)
        self.store.flush()
        return path

    def restore_index(self) -> int:
        """Fast restore of the mesh routing state from disk — no decrypt
        pass, no plaintext (the checkpoint holds only LSH codes).  Returns
        the number of live rows."""
        rt = self.cfg.runtime
        path = os.path.join(self.base_dir, "mesh_state.npz")
        with np.load(path) as z:   # close the zip handle before restore
            rows = int(z["shard_rows"])
        self.index = ShardedIndex.restore_state(
            path, self.mesh,
            keep_codes=(rt.rerank_limit > 0 and rt.routing_mode != "scan"),
            keep_bits=self._scan_layout(rows))
        self.index.merge_backend = rt.mesh_merge
        self.store.set_range_size(self.index.shard_rows)
        self.n = self.index.n
        # deletions live in the shard stores' metadata (the mesh checkpoint
        # holds only codes) — re-derive the device-side mask
        dead = self.store.meta.tombstoned_ids()
        if len(dead):
            self.index.mark_deleted(dead)
        return self.n

    # -- forward security --------------------------------------------------------

    def rotate_and_migrate(self, ids=None):
        """Rotate the shared key (through the rotation service — pin/freeze
        honored) and migrate the given ids (default: every live point) to
        the new version — rotation never touches the mesh routing state."""
        self.rotation.force_rotate_now()
        if ids is None:
            ids = np.arange(self.n, dtype=np.int64)
        return self.store.reencrypt_ids(ids)

    def migration_remaining(self, version: int) -> int:
        return self.rotation.migration_remaining(version)

    def compact_storage(self) -> dict:
        """Reclaim re-encryption garbage across every shard arena (the
        mesh analogue of the single-device ``compact_storage``).  Logical
        deletions older than this point become permanent."""
        freed = 0
        for kv in sorted(self.store.meta.live_versions()):
            freed += self.store.compact_version(kv)
        return {"bytes_freed": freed,
                "storage_bytes": self.store.size_bytes()}

    def size_bytes(self) -> int:
        return self.store.size_bytes()

    def close(self) -> None:
        if self.background:
            self.background.stop()
        self.store.close()
