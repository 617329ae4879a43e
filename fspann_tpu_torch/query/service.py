"""Decrypt-and-refine query execution (reference query/QueryServiceImpl.java).

Pipeline per batch of tokens:
  Stage A  — device routing: ranked candidate ids per query (index.route_batch)
  Stage B  — host bulk load + ONE batched multi-key AES-GCM open, fused with
             scoring (the C loop emits each candidate's norm and query dot)
  Stage C  — host exact L2 + top-K from those scalars
  Retry    — queries with returned < K or decrypted < min(10*K, limit) are
             re-run ONCE as a sub-batch with a widened decrypt budget
             (reference adaptive retry :327-337, needRetry :444-447)
  Tracking — successfully refined ids recorded into the ReencryptionTracker
             (reference :342-351 in a finally block)

The reference walks candidates one at a time through RocksDB + JCE; here the
ranked ids of a whole batch cross the device→host boundary once, as an
asynchronous copy into pinned host memory that overlaps the previous
batch's host AES.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import SystemConfig
from ..crypto.keys import KeyManager
from ..crypto.rotation import ReencryptionTracker
from ..index.service import PartitionedIndex
from ..store.point_store import PointStore
from ..types import QueryResult, QueryToken, SearchStats


class StaleTokenError(ValueError):
    """A query token's key version is retired/unknown — the caller must
    re-derive the token under a live key (see QueryToken.derive)."""


class _HostCopy:
    """Device→host copies started now, waited for later.

    CUDA tensors are copied ``non_blocking`` into pinned host buffers on the
    current stream, followed by a recorded event; :meth:`get` waits on that
    event only.  numpy arrays and CPU tensors pass straight through."""

    def __init__(self, arrays):
        self._out = []
        self._event = None
        for a in arrays:
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a, non_blocking=True)
                self._out.append(h)
                if self._event is None:
                    self._event = torch.cuda.Event()
            else:
                self._out.append(a)
        if self._event is not None:
            self._event.record()

    def get(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [None if a is None else _host(a) for a in self._out]


def _host(a) -> np.ndarray:
    """numpy view of a host tensor/array; a device tensor is copied."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _topk_from_d2(d2: np.ndarray, cand_ids: np.ndarray, valid: np.ndarray,
                  k: int):
    """Shared stage-C tail: top-k by squared distance (invalid = inf)."""
    q, r = d2.shape
    d2 = np.where(valid, np.maximum(d2, 0.0), np.inf)
    kk = min(k, r)
    part = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
    part_d = np.take_along_axis(d2, part, axis=1)
    order = np.argsort(part_d, axis=1, kind="stable")
    idx = np.take_along_axis(part, order, axis=1)
    dsel = np.take_along_axis(d2, idx, axis=1)
    ok = np.isfinite(dsel)
    ids = np.where(ok, np.take_along_axis(cand_ids, idx, axis=1), -1)
    dists = np.where(ok, np.sqrt(np.where(ok, dsel, 0.0)), np.inf)
    n_scored = valid.sum(axis=1).astype(np.int32)
    if kk < k:
        ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
        dists = np.pad(dists, ((0, 0), (0, k - kk)),
                       constant_values=np.inf)
    return ids.astype(np.int64), dists.astype(np.float32), n_scored


def _host_refine_scored(qvecs: np.ndarray, dots: np.ndarray, c2: np.ndarray,
                        cand_ids: np.ndarray, valid: np.ndarray, k: int):
    """Stage C from the FUSED decrypt-and-score outputs alone: the C AES
    loop emitted per-candidate norms and query dots while each plaintext
    row was in L1, so exact L2 needs no candidate matrix at all —
    d2 = |c|^2 - 2<c,q> + |q|^2 over [q, r] f32 scalars."""
    q2 = np.einsum("ij,ij->i", qvecs, qvecs)
    d2 = c2 - 2.0 * dots + q2[:, None]
    return _topk_from_d2(d2, cand_ids, valid, k)


@dataclass
class BatchSearchResult:
    ids: np.ndarray          # int64 [Q, K], -1 pad
    distances: np.ndarray    # f32 [Q, K], inf pad
    stats: list[SearchStats] = field(default_factory=list)

    def results(self, qi: int) -> list[QueryResult]:
        out = []
        for pid, d in zip(self.ids[qi], self.distances[qi]):
            if pid >= 0 and np.isfinite(d):
                out.append(QueryResult(int(pid), float(d)))
        return out


class QueryService:
    def __init__(self, index: PartitionedIndex, store: PointStore,
                 km: KeyManager, cfg: SystemConfig,
                 tracker: ReencryptionTracker | None = None):
        self.index = index
        self.store = store
        self.km = km
        self.cfg = cfg
        self.tracker = tracker
        self.last_stats: list[SearchStats] = []
        # Optional per-batch hook fed the batch's unique touched ids —
        # the facade wires immediate selective re-encryption through it
        # (reference reenc.mode=immediate, ForwardSecureANNSystem.java:1345)
        self.on_touched = None
        # predicted live-prefix width (pow2) for the candidate transfer,
        # carried across batches so the slice is dispatched AT ROUTE TIME
        # (overlapped) instead of as a serial round trip at consume time
        self._slice_pred: int | None = None
        # reusable decrypt-and-score outputs (grown on demand): avoids
        # page-faulting fresh candidate-set-sized buffers every batch; rows
        # are masked by `ok`, never read stale
        self._norms_buf = np.zeros(0, np.float32)
        self._dots_buf = np.zeros(0, np.float32)

    # -- public ------------------------------------------------------------------

    def search(self, token: QueryToken) -> list[QueryResult]:
        batch = self.search_batch([token])
        return batch.results(0)

    def search_batch(self, tokens: list[QueryToken]) -> BatchSearchResult:
        if not tokens:
            return BatchSearchResult(np.zeros((0, 0), np.int64),
                                     np.zeros((0, 0), np.float32))
        return self.search_batches([tokens])[0]

    def search_batches(self, batches: list[list[QueryToken]]
                       ) -> list[BatchSearchResult]:
        """Pipelined execution: the device routing for batch i+1 is
        dispatched (CUDA launches and the device→host copy of its ranked
        ids are asynchronous) before the host decrypt+refine of batch i
        consumes its results, so GPU routing and host AES overlap across
        batches.

        Latency accounting — ONE definition everywhere: each batch's
        ``server_ns`` is its EXCLUSIVE wall time (consume end minus the
        later of its own dispatch and the previous batch's consume end),
        divided per query.  The series sums to the run's wall clock, so
        mean(ART) == wall/Q and p50/p95 come from the same numbers — no
        double-counting of pipeline overlap."""
        rt = self.cfg.runtime
        results: list[BatchSearchResult] = []
        pending = None
        prev_end: float | None = None
        for tokens in list(batches) + [None]:
            current = None
            if tokens:
                t_start = time.perf_counter()
                qvecs = self._decrypt_queries(tokens)
                # limit=None lets the index pick the per-mode default
                # (refinement_limit for probe, effective_refinement for scan)
                routed = self._dispatch_route(tokens, rt.effective_probes(),
                                              None)
                current = (tokens, qvecs, routed, t_start)
            if pending is not None:
                res = self._finish_batch(*pending)
                end = time.perf_counter()
                start = pending[3] if prev_end is None \
                    else max(pending[3], prev_end)
                per_q_ns = int((end - start) * 1e9 / max(len(res.stats), 1))
                for s in res.stats:
                    s.server_ns = per_q_ns
                prev_end = end
                results.append(res)
            pending = current
        return results

    def _finish_batch(self, tokens, qvecs, routed, t_start
                      ) -> BatchSearchResult:
        k = max(t.top_k for t in tokens)
        rt = self.cfg.runtime
        touched_parts: list[np.ndarray] = []
        ids, dists, stats = self._consume_pass(tokens, qvecs, routed, k,
                                               touched_parts, t_start)

        # Adaptive retry (once) for underfilled queries — synchronous, rare.
        # Probe mode widens probes (reference probeOverride=10 escalation);
        # scan mode widens the decrypt budget L instead — the scan is
        # already exact over the whole corpus, so re-probing would re-pay
        # an identical scan for an identical result.  Skip entirely when L
        # already covers every live row (nothing wider exists).
        need = [qi for qi, s in enumerate(stats) if self._need_retry(s, k)]
        if rt.routing_mode == "scan":
            retry_probes, retry_limit = rt.effective_probes(), \
                2 * rt.effective_refinement()
            do_retry = bool(need) and \
                rt.effective_refinement() < self.index.size
        else:
            retry_probes, retry_limit = rt.retry_probes, None
            do_retry = bool(need) and \
                rt.retry_probes > rt.effective_probes()
        if do_retry:
            sub_tokens = [tokens[qi] for qi in need]
            sub_q = qvecs[need]
            t_retry = time.perf_counter()
            routed2 = self._dispatch_route(sub_tokens, retry_probes,
                                           retry_limit)
            rids, rdists, rstats = self._consume_pass(
                sub_tokens, sub_q, routed2, k, touched_parts, t_retry)
            for j, qi in enumerate(need):
                ids[qi], dists[qi] = rids[j], rdists[j]
                rstats[j].retried = True
                stats[qi] = rstats[j]

        if touched_parts and (self.tracker is not None
                              or self.on_touched is not None):
            # every successfully DECRYPTED candidate is "touched" (reference
            # QueryServiceImpl.java:263 adds each scored id, recorded in the
            # finally block :342-351) — the selective re-encryption set, not
            # merely the returned top-K
            touched = np.unique(np.concatenate(touched_parts))
            if self.tracker is not None:
                self.tracker.record(touched)
            if self.on_touched is not None:
                self.on_touched(touched)
        self.last_stats = stats
        return BatchSearchResult(ids, dists, stats)

    # -- internals ----------------------------------------------------------------

    def _decrypt_queries(self, tokens: list[QueryToken]) -> np.ndarray:
        """Server-side token decrypt under the token's key version
        (trusted-eval shortcut, reference QueryServiceImpl.java:124-135).
        A token whose key version is not live fails with an explicit
        StaleTokenError — the reference substitutes the current version
        there, which only defers the failure to an undiagnosable
        "tag verification failed" downstream (the token was sealed under a
        different key).  ONE multi-key batch open for the whole token
        batch — the per-token Python loop was ~0.5 ms/batch of pure
        interpreter overhead on the serving path."""
        from ..crypto import aesgcm

        n = len(tokens)
        versions: list[int] = []
        keys = []
        key_idx = np.empty(n, np.uint32)
        live = self.km.live_versions()
        for i, t in enumerate(tokens):
            kv = t.key_version
            if kv not in live:
                raise StaleTokenError(
                    f"query token key version {kv} is retired or unknown "
                    f"(current: v{self.km.current_version}); re-derive the "
                    f"token under a live key")
            if kv not in versions:
                versions.append(kv)
                keys.append(self.km.gcm_for(kv))
            key_idx[i] = versions.index(kv)
        body = self.index.dim * 4
        ct = np.empty(n * body, np.uint8)
        ivs = np.empty((n, 12), np.uint8)
        tags = np.empty((n, 16), np.uint8)
        for i, t in enumerate(tokens):
            if len(t.encrypted_query) != body + 16:
                raise ValueError(
                    f"token dimension mismatch: ciphertext is "
                    f"{len(t.encrypted_query)}B, index dim {self.index.dim} "
                    f"needs {body + 16}B")
            ct[i * body:(i + 1) * body] = np.frombuffer(
                t.encrypted_query[:body], np.uint8)
            tags[i] = np.frombuffer(t.encrypted_query[body:], np.uint8)
            ivs[i] = np.frombuffer(t.iv, np.uint8)
        offs = (np.arange(n, dtype=np.uint64) * body)
        lens = np.full(n, body, np.uint64)
        pt, ok = aesgcm.open_batch(keys, key_idx, ivs, [b""] * n,
                                   ct, offs, lens, tags)
        if not ok.all():
            raise ValueError("query token tag verification failed")
        return pt.view("<f4").reshape(n, self.index.dim).astype(
            np.float32, copy=True)

    def _need_retry(self, s: SearchStats, k: int) -> bool:
        """Reference needRetry:444-447: returned < K or decrypted < 10*K.
        The decrypt budget is the post-rerank truncation when the full-code
        re-rank is enabled (else every query would retry forever).  With the
        adaptive per-query decrypt budget the small count is INTENTIONAL
        (score-competitive set exhausted), so the decrypt floor drops to the
        adaptive floor — retry still fires when tombstones ate the budget
        (cand_decrypted below the floor) or the result underfilled."""
        rt = self.cfg.runtime
        budget = min(10 * k, rt.effective_refinement())
        if rt.routing_mode == "scan" and rt.adaptive_decrypt_margin > 0:
            budget = min(budget, max(rt.adaptive_decrypt_floor,
                                     rt.adaptive_decrypt_anchor))
        return s.returned < k or s.cand_decrypted < budget

    def _dispatch_route(self, tokens, probes, limit):
        """Stage A dispatch — returns (routed, copies, width, dispatch_ns).
        On a CUDA scan device this only enqueues work (the pipeline overlaps
        it with the previous batch's host AES); on the CPU the scan computes
        synchronously here and dispatch_ns — charged to the route stage —
        carries its true cost.  ``copies`` holds the device→host copies of
        the ranked id matrix cut to the predicted live width (previous
        batch's, pow2-bucketed) and of the per-query counters, started now
        so the consume side finds them on the host."""
        # host-side stack: tokens carry numpy codes, and the scan path
        # unpacks them on the host anyway
        qc = np.stack([t.codes for t in tokens])
        qk = np.stack([t.keys for t in tokens])
        t0 = time.perf_counter()
        routed = self.index.route_batch(qc, qk, probes, limit)
        dispatch_ns = int((time.perf_counter() - t0) * 1e9)
        r_full = routed.ids.shape[1]
        pred = self._slice_pred
        if pred is not None and pred < 0.7 * r_full:
            ids_slice, width = routed.ids[:, :pred], pred
        else:
            ids_slice, width = routed.ids, r_full
        copies = _HostCopy((ids_slice, routed.n_unique, routed.n_raw,
                            routed.n_dec))
        return routed, copies, width, dispatch_ns

    def _consume_pass(self, tokens, qvecs, dispatched, k, touched_parts,
                      t_start):
        routed, copies, pred, dispatch_ns = dispatched
        # stage attribution: route_ns counts only the time THIS thread spends
        # blocked on the device result — pipeline overlap (the previous
        # batch's host work ran between dispatch and here) is not charged
        t_wait = time.perf_counter()
        # Wait for the copies started at dispatch: the per-query counters
        # and the ranked ids at the PREDICTED live width.  Ids are sorted
        # best-first with pads at the end, so the first max(n_unique)
        # columns carry every live candidate.  On a mispredict (need > pred)
        # fall back to the full matrix — correctness never depends on the
        # prediction.
        ids_slice, n_unique, n_raw, n_dec = copies.get()
        r_full = routed.ids.shape[1]
        # adaptive decrypt budget: only the first n_dec[q] ranked ids are
        # score-competitive — slice/transfer to the batch max and mask the
        # per-query tail so the AES loop never touches it
        width = n_unique if n_dec is None else n_dec
        need = max(int(width.max(initial=1)), k, 1)
        if need <= pred:
            cand_ids = ids_slice
        else:   # mispredict: fall back to the full matrix
            cand_ids = _host(routed.ids)
        self._slice_pred = min(max(256, 1 << (need - 1).bit_length()), r_full)
        if n_dec is not None:
            cand_ids = np.where(
                np.arange(cand_ids.shape[1])[None, :] < n_dec[:, None],
                cand_ids, -1)
        t1 = time.perf_counter()

        q, r = cand_ids.shape
        flat = np.ascontiguousarray(cand_ids).reshape(-1)
        # fused decrypt-and-score: the C AES loop emits per-candidate
        # (norm, query-dot) while each row is in L1 — the plaintext never
        # reaches DRAM, and no candidate matrix exists to re-read
        if self._norms_buf.size < flat.size:
            self._norms_buf = np.zeros(flat.size, np.float32)
        if self._dots_buf.size < flat.size:
            self._dots_buf = np.zeros(flat.size, np.float32)
        norms = self._norms_buf[:flat.size]
        dots = self._dots_buf[:flat.size]
        ok_flat = self.store.load_score_batch(flat, qvecs, r, norms, dots)
        valid = ok_flat.reshape(q, r)
        if touched_parts is not None:
            touched_parts.append(flat[ok_flat])
        t2 = time.perf_counter()
        ids, dists, n_scored = _host_refine_scored(
            qvecs, dots.reshape(q, r), norms.reshape(q, r), cand_ids, valid,
            k)
        t3 = time.perf_counter()

        stats = []
        for qi in range(q):
            returned = int((ids[qi] >= 0).sum())
            stats.append(SearchStats(
                cand_raw=int(n_raw[qi]), cand_unique=int(n_unique[qi]),
                cand_refined=int((cand_ids[qi] >= 0).sum()),
                cand_decrypted=int(n_scored[qi]), returned=returned,
                route_ns=int((t1 - t_wait) * 1e9 / q) + dispatch_ns // q,
                decrypt_ns=int((t2 - t1) * 1e9 / q),
                refine_ns=int((t3 - t2) * 1e9 / q)))
        return ids, dists, stats
