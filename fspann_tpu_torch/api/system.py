"""System facade: lifecycle SETUP → INDEX → FINALIZE → QUERY → S-R.E → EXPORT.

Reference counterpart: ``api/ForwardSecureANNSystem.java`` (2,275 lines of
wiring).  The facade owns: config, keystore, point store, rotation service,
routing index, token factory, query service, re-encryption tracker, profiler;
and implements the evaluation loop with recall/ratio metrics at the standard
K set, end-of-run selective re-encryption, restore, and artifact export.

Like the reference's evaluation mode, distance-ratio computation reads the
plaintext base (reference ``BaseVectorReader`` mmap :982-1101 — trusted-eval
shortcut); pass ``base=None`` to skip ratios.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from ..config import SystemConfig, load_config
from ..crypto.keys import KeyManager
from ..crypto.coordinator import SelectiveReencCoordinator
from ..crypto.rotation import (BackgroundReencryption, KeyRotationService,
                               ReencryptionTracker, RotationPolicy)
from ..store.write_buffer import BufferedInserter
from ..index.service import PartitionedIndex
from ..io import loaders
from ..io.groundtruth import GroundtruthManager
from ..query.aggregates import Aggregates, write_csvs
from ..query.service import QueryService
from ..query.token import QueryTokenFactory
from ..query.diagnostics import QueryDiagnostics
from ..store.point_store import PointStore
from ..types import QueryToken
from ..utils.cache import ExpiringCache
from ..utils.metrics import MetricsRegistry
from ..utils.profiler import Profiler, span
from ..utils.storage_metrics import StorageMetrics


class ForwardSecureANNSystem:
    def __init__(self, cfg: SystemConfig | str, base_dir: str, dim: int,
                 query_batch: int = 64,
                 key_manager: KeyManager | None = None, device=None):
        """``key_manager`` injects a shared keystore (MultiDimSystem: one
        keystore across per-dimension sub-systems, reference DimensionState
        wiring ForwardSecureANNSystem.java:360-375).  Every component below
        captures the SAME instance at construction — no post-hoc swapping.
        ``device`` is the torch device the index serves from: the CUDA card
        unless the caller names another (``"cpu"``)."""
        if isinstance(cfg, str):
            cfg = load_config(cfg)
        self.cfg = cfg
        self.base_dir = base_dir
        self.dim = dim
        self.query_batch = query_batch
        os.makedirs(base_dir, exist_ok=True)

        self.km = key_manager if key_manager is not None else KeyManager(
            os.path.join(base_dir, "keystore.blob"),
            retention_max=cfg.keys.retention_max)
        self.store = PointStore(base_dir, self.km, dim,
                                dtype=cfg.runtime.storage_dtype)
        self.rotation = KeyRotationService(
            self.km, self.store,
            RotationPolicy(cfg.keys.ops_threshold, cfg.keys.age_threshold_ms))
        self.index = PartitionedIndex(
            cfg, dim, bank_path=os.path.join(base_dir, "bank.npz"),
            table_path=os.path.join(base_dir, "table.npz"), device=device)
        self.tokens = QueryTokenFactory(self.index, self.km, dim)
        self.tracker = ReencryptionTracker()
        self.query_service = QueryService(self.index, self.store, self.km,
                                          cfg, self.tracker)
        self.profiler = Profiler()
        self.metrics = MetricsRegistry()
        self.diagnostics = QueryDiagnostics()
        self.storage_metrics = StorageMetrics(base_dir)
        # expiring single-query result cache keyed by query bytes
        # (reference StringKeyedCache, ForwardSecureANNSystem.java:1103-1151)
        self.query_cache = ExpiringCache(capacity=2048, ttl_s=60.0)
        self._cache_gen = 0   # bumped on any mutation that can change results
        self.reenc_coordinator = SelectiveReencCoordinator(
            self.rotation, self.storage_metrics, self.metrics,
            csv_path=os.path.join(base_dir, "reencrypt_metrics.csv"))
        self.insert_buffer = BufferedInserter(self._sink_batch, dim)
        if cfg.reencryption.enabled and cfg.reencryption.mode == "immediate":
            self.query_service.on_touched = self._migrate_touched_now
        self.background = None
        if cfg.reencryption.background_enabled:
            self.background = BackgroundReencryption(
                self.rotation, cfg.reencryption.background_interval_s,
                cfg.reencryption.background_batch, metrics=self.metrics)
            self.background.start()

    # -- INDEX ---------------------------------------------------------------

    def insert(self, point_id: int, vec: np.ndarray) -> None:
        """Single-point insert, buffered into store-sized batches
        (EncryptedPointBuffer analogue; flushed by finalize/flush_all)."""
        self.insert_buffer.add(point_id, vec)

    def _sink_batch(self, ids, vecs) -> None:
        self.batch_insert(ids, vecs)

    def batch_insert(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Encrypt+persist then stage for routing (reference batchInsert:479;
        rotation check once per batch :531)."""
        self.rotation.rotate_if_needed()
        vecs, parts = self.store.quantize_parts(vecs)
        with self.profiler.timed("insert"):
            self.store.insert_batch(ids, vecs, prequant=parts)
            self.index.stage(ids, vecs)
        self.rotation.track_operations(len(ids))

    def index_stream(self, data: np.ndarray | str, batch_size: int = 10_000,
                     limit: int | None = None) -> int:
        """Stream a corpus (array or vecs file path) into the system
        (reference indexStream:438; ids are file ordinals)."""
        with span("system.index_stream"):
            if isinstance(data, str):
                data = loaders.load_vectors(data)
            total = 0
            for start, batch in loaders.stream_batches(data, batch_size,
                                                       limit):
                ids = np.arange(start, start + len(batch), dtype=np.int64)
                self.batch_insert(ids, batch)
                total += len(batch)
            return total

    def insert_live(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Insert AFTER finalize, searchable immediately — beyond the
        reference (whose index freezes at finalizeForSearch).  Requires
        routing_mode='scan': the new code bits append to the device bit
        matrix; ciphertexts persist through the normal encrypted path and
        key rotation covers them like any other point."""
        with span("system.insert_live"):
            ids = np.asarray(ids, np.int64)
            self.rotation.rotate_if_needed()
            vecs, parts = self.store.quantize_parts(vecs)
            with self.profiler.timed("insert_live"):
                self.index.append_rows(ids, vecs)   # validates first
                self.store.insert_batch(ids, vecs, prequant=parts)
            self.rotation.track_operations(len(ids))
            self._cache_gen += 1

    def finalize_for_search(self) -> None:
        with span("system.finalize"):
            self.insert_buffer.flush()
            with self.profiler.timed("finalize"):
                self.index.finalize()
            self.store.meta.save_index_version(self.km.current_version)
            self.store.flush()

    def delete(self, ids) -> None:
        self.store.delete(ids)
        self.index.mark_deleted(ids)
        self._cache_gen += 1

    def undelete(self, ids) -> list[int]:
        """Reverse a logical deletion (possible until compaction/retire).
        Only ids the store could actually restore — backing ciphertext and
        key still present — become routable again; the rest stay deleted."""
        restored = self.store.undelete(ids)
        for pid in restored:
            self.index._deleted.discard(int(pid))
        self.index._tombstones_dirty = True
        self._cache_gen += 1
        return restored

    # -- QUERY ---------------------------------------------------------------

    def create_token(self, query: np.ndarray, top_k: int) -> QueryToken:
        return self.tokens.create(query, top_k)

    def kadaptive_probe_enabled(self) -> bool:
        return self.cfg.kadaptive.enabled

    def kadaptive_widen(self) -> tuple[int, int]:
        """Probe-only adaptive widening (reference runKAdaptiveProbeOnly,
        ForwardSecureANNSystem.java:1598-1617): multiply the current
        effective probe count by ``probe_factor``, capped at ``max_fanout``,
        WITHOUT executing a search.  No-op unless kadaptive.enabled.
        Returns (old_probes, new_probes)."""
        import dataclasses

        ka = self.cfg.kadaptive
        cur = self.cfg.runtime.effective_probes()
        if not ka.enabled:
            return cur, cur
        new = max(cur, min(int(cur * ka.probe_factor), ka.max_fanout))
        self.cfg = dataclasses.replace(
            self.cfg,
            runtime=dataclasses.replace(self.cfg.runtime, probe_override=new))
        # components read cfg.runtime per call — repoint them at the new
        # frozen config object
        self.query_service.cfg = self.cfg
        self.index.cfg = self.cfg
        return cur, new

    def search(self, token: QueryToken):
        with span("system.search"):
            if self.background:
                self.background.note_query()
            # keyed by the query digest (plaintext identity), NOT the LSH
            # codes — distinct nearby queries share codes by design and must
            # not alias
            cache_key = (self._cache_gen, token.cache_key, token.top_k)
            hit = self.query_cache.get(cache_key)
            if hit is not None:
                self.metrics.count("query.cache_hits")
                return hit
            with self.metrics.timer("query.search_ms"):
                out = self.query_service.search(token)
            self.query_cache.put(cache_key, out)
            self.metrics.count("query.searches")
            return out

    def run_queries(self, queries: np.ndarray,
                    gtm: GroundtruthManager | None = None,
                    base: np.ndarray | None = None,
                    ks: tuple[int, ...] | None = None,
                    real_src: np.ndarray | None = None) -> Aggregates:
        """Evaluation loop (reference runQueries:622-747): batch queries,
        search at MAX_K once, compute metrics per K by prefix slicing.

        ``real_src`` enables decoy interleaving (reference
        ForwardSecureANNSystem.java:172-183 + DecoyQueryGenerator.java:91):
        entry i is the ORIGINAL index of query i (for gt/metrics lookup), or
        -1 for an injected decoy.  Decoys run the FULL pipeline — tokens,
        search, touched-set tracking; that dilution is the cloak — but
        contribute nothing to recall/ratio, diagnostics, or profiler rows.

        Bookkeeping is vectorized per batch (numpy column blocks into the
        profiler); per-row object construction cost ~1 ms/query ×7
        K-variants at serving rates."""
        ks = ks or self.cfg.eval.k_variants
        max_k = max(ks)
        queries = np.asarray(queries, np.float32)
        nq = len(queries)
        if real_src is None:
            real_src = np.arange(nq, dtype=np.int64)
        else:
            real_src = np.asarray(real_src, np.int64)
            if len(real_src) != nq:
                raise ValueError("real_src length must match queries")
        probes = self.cfg.runtime.effective_probes()
        n_base = max(self.index.size, 1)
        run_mark = self.profiler.mark()   # aggregate only THIS run's rows

        starts = list(range(0, nq, self.query_batch))
        batches = [self.tokens.create_batch(queries[s:s + self.query_batch],
                                            max_k) for s in starts]
        with self.profiler.timed("query"):
            all_res = self.query_service.search_batches(batches)
        for bi, (s, res) in enumerate(zip(starts, all_res)):
            toks = batches[bi]
            qb = len(toks)
            if self.background:
                self.background.note_query()
            st = res.stats
            server_ms = np.fromiter((t.server_ns for t in st),
                                    np.float64, qb) / 1e6
            decrypt_ms = np.fromiter((t.decrypt_ns for t in st),
                                     np.float64, qb) / 1e6
            cand_raw = np.fromiter((t.cand_raw for t in st), np.int64, qb)
            # operational metrics cover the whole stream, decoys included
            self.metrics.record_many("query.server_ms", server_ms)
            self.metrics.record_many("query.decrypt_ms", decrypt_ms)
            n_warn = int((cand_raw > self.cfg.runtime.hard_cap).sum())
            if n_warn:
                # fanout guard (reference -Dguard.fanout.warn,
                # ForwardSecureANNSystem.java:115)
                self.metrics.count("query.fanout_warn", n_warn)

            src_block = real_src[s:s + qb]
            rpos = np.flatnonzero(src_block >= 0)
            if not len(rpos):
                continue
            orig = src_block[rpos]
            ids_r = res.ids[rpos]
            dist_r = res.distances[rpos]
            recalls, ratios = self._metrics_block(
                orig, queries[s:s + qb][rpos], ids_r, dist_r, ks, gtm, base)
            if gtm is not None:
                k10 = min(10, max_k)
                r10s = recalls.get(k10, recalls[min(recalls)]) if recalls \
                    else np.zeros(len(rpos))
                for j, oi in enumerate(orig):
                    self.diagnostics.record(int(oi), float(r10s[j]),
                                            ids_r[j][:k10], dist_r[j][:k10],
                                            gtm.get(int(oi), k10))
            nr = len(rpos)
            cand_refined = np.fromiter((t.cand_refined for t in st),
                                       np.int64, qb)[rpos]
            common = dict(
                query_index=orig,
                candidate_ratio_at_k=cand_refined / n_base,
                cand_raw=cand_raw[rpos],
                cand_unique=np.fromiter((t.cand_unique for t in st),
                                        np.int64, qb)[rpos],
                cand_refined=cand_refined,
                cand_decrypted=np.fromiter((t.cand_decrypted for t in st),
                                           np.int64, qb)[rpos],
                returned=np.fromiter((t.returned for t in st),
                                     np.int64, qb)[rpos],
                retried=np.fromiter((t.retried for t in st), bool, qb)[rpos],
                route_ms=np.fromiter((t.route_ns for t in st),
                                     np.float64, qb)[rpos] / 1e6,
                decrypt_ms=decrypt_ms[rpos],
                refine_ms=np.fromiter((t.refine_ns for t in st),
                                      np.float64, qb)[rpos] / 1e6,
                server_ms=server_ms[rpos],
                token_key_version=np.fromiter(
                    (t.key_version for t in toks), np.int64, qb)[rpos],
                probes=np.full(nr, probes, np.int64))
            nan = np.full(nr, np.nan)
            for k in ks:
                self.profiler.record_block(
                    k=np.full(nr, k, np.int64),
                    recall_at_k=np.asarray(recalls[k], np.float64)
                    if recalls else nan,
                    distance_ratio_at_k=np.asarray(ratios[k], np.float64)
                    if ratios else nan,
                    **common)
        return Aggregates.from_profiler(self.profiler, run_mark)

    def _metrics_block(self, orig_idx, qvecs, ret_ids, ret_dist, ks, gtm,
                       base):
        """Vectorized recall@K / distance-ratio@K for one query batch
        (reference computeMetricsAtK:770-835; QueryMetrics.java:7-21).
        ``orig_idx`` maps block rows to ORIGINAL query indices (decoy
        interleaving makes the two differ).

        recall@K = |returned@K ∩ gt@K| / K; ratio@K = mean over i<K of
        max(d(q, ret_i)/d(q, gt_i), 1).
        """
        if gtm is None:
            return {}, {}
        max_k = max(ks)
        qb = len(orig_idx)
        gt = gtm.gt[orig_idx, :max_k]                     # [QB, maxK]
        recalls: dict[int, np.ndarray] = {}
        ratios: dict[int, np.ndarray] = {}
        d_gt = None
        if base is not None:
            gvecs = np.asarray(base[gt.reshape(-1)], np.float32)
            diffs = gvecs.reshape(qb, max_k, -1) - qvecs[:, None, :]
            d_gt = np.sqrt(np.einsum("qkd,qkd->qk", diffs, diffs))
        for k in ks:
            got = ret_ids[:, :k]                          # [QB, k]
            # membership of each returned id in the query's gt@k set
            hits = (got[:, :, None] == gt[:, None, :k]) & (got[:, :, None] >= 0)
            recalls[k] = hits.any(axis=2).sum(axis=1) / k
            if d_gt is not None:
                denom = np.maximum(d_gt[:, :k], 1e-12)
                r = np.maximum(ret_dist[:, :k] / denom, 1.0)
                valid = (got >= 0) & np.isfinite(ret_dist[:, :k])
                cnt = np.maximum(valid.sum(axis=1), 1)
                ratios[k] = np.where(valid, r, 0.0).sum(axis=1) / cnt
        return recalls, ratios

    # -- S-R.E (forward security) ----------------------------------------------

    def _migrate_touched_now(self, ids) -> None:
        """``reenc.mode=immediate`` (reference ForwardSecureANNSystem.java:122,
        1345-1360): migrate each search batch's touched set to the current
        key version right after the batch, instead of deferring to the
        end-of-run pass.  When everything touched is already current this is
        one vectorized metadata lookup — bounded per-query overhead."""
        rep = self.rotation.reencrypt_touched(ids)
        if rep.reencrypted:
            self.metrics.count("reencryption.immediate_migrated",
                               rep.reencrypted)
        # nothing left for the end-of-run pass
        self.tracker.drain()

    def run_selective_reencryption(self) -> dict:
        """End-of-run pass (reference runSelectiveReencryptionIfNeeded:1739):
        force one rotation, drain the touched set, migrate, report."""
        if not self.cfg.reencryption.enabled:
            return {"skipped": True}
        if self.rotation.rotation_frozen \
                or self.rotation.pinned_version is not None:
            # query-only restore pins a version; the end-of-run rotation
            # must not rotate it out from under the pin
            return {"skipped": True, "reason": "rotation pinned/frozen"}
        old_version = self.km.current_version
        self.rotation.force_rotate_now()
        touched = self.tracker.drain()
        row = self.reenc_coordinator.run_once_with_version(
            self.km.current_version, touched)
        out = dict(row)
        out["old_version"] = old_version
        out["new_version"] = self.km.current_version
        self._reenc_last = out
        return out

    # -- RESTORE ------------------------------------------------------------------

    def restore_index_from_disk(self, version: int | None = None) -> int:
        """Restore routing state: the fast path loads the persisted partition
        table (deterministic given data+config); otherwise decrypt every live
        point and re-encode (reference restoreIndexFromDisk:926-948).

        ``version`` pins an EXPLICIT key version (reference
        ``-Drestore.version``, ForwardSecureANNSystem.java:950-962) — it must
        still be live (not securely deleted); otherwise the latest persisted
        index version is detected and pinned (:1998-2005)."""
        dead = self.store.meta.tombstoned_ids()
        total_rows = len(self.store.meta) + len(dead)
        if self.index.load_table(os.path.join(self.base_dir, "table.npz"),
                                 expect_rows=total_rows):
            n = len(self.store.meta)
            if len(dead):
                self.index.mark_deleted(dead)
        else:
            n = 0
            for ids, vecs in self.store.restore_iter():
                self.index.stage(ids, vecs)
                n += len(ids)
            self.index.finalize()
        if version is not None:
            self.rotation.activate_version(version)  # raises if deleted
        else:
            saved = self.store.meta.index_version
            if saved:
                self.rotation.activate_version(
                    min(saved, self.km.current_version))
        return n

    # -- EXPORT / SHUTDOWN ----------------------------------------------------------

    def export_artifacts(self, results_dir: str) -> None:
        """profiler_metrics.csv, summary/accuracy/cost.csv,
        reencrypt_metrics.csv, metrics_summary.txt with config provenance
        (reference exportArtifacts:1187-1279)."""
        os.makedirs(results_dir, exist_ok=True)
        self.profiler.export_csv(
            os.path.join(results_dir, "profiler_metrics.csv"))
        agg = Aggregates.from_profiler(self.profiler)
        write_csvs(agg, results_dir)
        reenc = getattr(self, "_reenc_last", None)
        if reenc:
            with open(os.path.join(results_dir, "reencrypt_metrics.csv"),
                      "w") as f:
                f.write(",".join(reenc.keys()) + "\n")
                f.write(",".join(str(v) for v in reenc.values()) + "\n")
        self.diagnostics.export_csv(
            os.path.join(results_dir, "query_diagnostics.csv"))
        self.diagnostics.export_csv(
            os.path.join(results_dir, "retrieved_worst.csv"))
        self.diagnostics.export_samples_csv(
            os.path.join(results_dir, "retrieved_samples.csv"))
        with open(os.path.join(results_dir, "metrics.txt"), "w") as f:
            f.write(self.metrics.export_text())
        cfg_sha = self.cfg.source_sha256 or hashlib.sha256(
            json.dumps(str(self.cfg)).encode()).hexdigest()
        with open(os.path.join(results_dir, "metrics_summary.txt"), "w") as f:
            f.write(f"config_sha256={cfg_sha}\n")
            f.write(f"profile={self.cfg.profile_name}\n")
            f.write(f"key_version={self.km.current_version}\n")
            f.write(f"index_size={self.index.size}\n")
            f.write(f"storage_bytes={self.store.size_bytes()}\n")
            f.write(agg.paper_line() + "\n")
            f.write(f"generated_at={time.strftime('%Y-%m-%dT%H:%M:%S')}\n")

    def compact_storage(self) -> dict:
        """Housekeeping: compact the metadata log and every live version's
        arena (reclaims re-encryption garbage; reference defers per-point
        file cleanup instead).  Logical deletions older than this point
        become permanent."""
        freed = 0
        for kv in sorted(self.store.meta.live_versions()):
            freed += self.store.compact_version(kv)
        self.store.meta.compact()
        self._cache_gen += 1
        return {"bytes_freed": freed,
                "storage_bytes": self.store.size_bytes()}

    def flush_all(self) -> None:
        if len(self.insert_buffer):
            # raises if the index is already frozen — surfacing the misuse
            # beats silently dropping buffered points
            self.insert_buffer.flush()
        if self.index._table_stale and self.index.table_path:
            # live inserts extended the scan state — refresh the checkpoint
            # so fast restore sees the appended rows
            self.index.save_table(self.index.table_path)
        self.store.meta.save_index_version(self.km.current_version)
        self.store.flush()
        self.km.persist()

    def shutdown(self) -> None:
        if self.background:
            self.background.stop()
        self.flush_all()
        self.store.close()
