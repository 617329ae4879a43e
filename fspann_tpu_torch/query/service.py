"""Decrypt-and-refine query execution (reference query/QueryServiceImpl.java).

Pipeline per batch of tokens:
  Stage A  — device routing: ranked candidate ids per query (index.route_batch)
  Stage B  — host bulk load + ONE batched multi-key AES-GCM open (for a
             ``PointStore`` one native pass on a pool of host threads,
             ``store/parallel_read.py``); with ``refine_backend="host"``
             fused with scoring (the C loop emits each candidate's norm and
             query dot), with "device" into a staging matrix
  Stage C  — "host": exact L2 + top-K from those scalars; "device": the
             [Q, R, d] candidates go to the index device for ops/refine
  Retry    — queries with returned < K or decrypted < min(10*K, limit) are
             re-run ONCE as a sub-batch with widened probes (probe mode,
             reference probeOverride=10) or a widened decrypt budget (scan
             mode) (reference adaptive retry :327-337, needRetry :444-447)
  Tracking — successfully refined ids recorded into the ReencryptionTracker
             (reference :342-351 in a finally block)

The reference walks candidates one at a time through RocksDB + JCE; here the
ranked ids of a whole batch cross the device→host boundary once, as an
asynchronous copy into pinned host memory that overlaps the previous
batch's host AES.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.autograd.profiler as _torch_profiler

from ..config import SystemConfig
from ..crypto.keys import KeyManager
from ..crypto.rotation import ReencryptionTracker
from ..index.service import PartitionedIndex
from ..ops import refine as refine_ops
from ..store import parallel_read
from ..store.point_store import PointStore
from ..types import QueryResult, QueryToken, SearchStats
from ..utils.profiler import span


class StaleTokenError(ValueError):
    """A query token's key version is retired/unknown — the caller must
    re-derive the token under a live key (see QueryToken.derive)."""


class _HostCopy:
    """Device→host copies started now, waited for later.

    CUDA tensors are copied ``non_blocking`` into pinned host buffers on
    their device's current stream; then one event is recorded on the
    current stream of each source device, after all of its copies, and
    :meth:`get` waits on those events only.  numpy arrays and CPU tensors
    pass straight through."""

    def __init__(self, arrays):
        self._out = []
        devices = []
        for a in arrays:
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a, non_blocking=True)
                self._out.append(h)
                if a.device not in devices:
                    devices.append(a.device)
            else:
                self._out.append(a)
        self._events = []
        for dev in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            self._events.append(event)

    def get(self) -> list:
        for event in self._events:
            event.synchronize()
        return [None if a is None else _host(a) for a in self._out]


def _host(a) -> np.ndarray:
    """numpy view of a host tensor/array; a device tensor is copied."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- candidate-id transfer packing ------------------------------------------------
# Row ids fit 24 bits at any corpus below ~16.7M rows, so the device packs
# (id + 1) into 3 little-endian bytes (+1 maps the -1 pad to 0) and the host
# widens them back: the ranked-id copy to the host moves 25% fewer bytes.

def _pack24(x: torch.Tensor) -> torch.Tensor:
    """int ids in [-1, _PACK24_MAX] → uint8 [..., 3] on ``x``'s device.
    ``id + 1`` is below 2^24, so int32 shifts suffice (no uint32)."""
    y = x.to(torch.int32) + 1
    return torch.stack([y & 0xFF, (y >> 8) & 0xFF, (y >> 16) & 0xFF],
                       dim=-1).to(torch.uint8)


_PACK24_MAX = (1 << 24) - 2        # largest id that survives the +1 encode


def _pack_transfer_enabled(device: torch.device) -> bool:
    """Pack only when the ids cross a device link: ids already on the
    host CPU gain nothing.  FSPANN_PACK24=1/0 forces it either way (tests
    use 1 to exercise the packed path on the CPU suite)."""
    v = os.environ.get("FSPANN_PACK24")
    if v is not None:
        return v not in ("0", "off")
    return device.type != "cpu"


def _unpack24(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b)
    v = (b[..., 0].astype(np.int32)
         | (b[..., 1].astype(np.int32) << 8)
         | (b[..., 2].astype(np.int32) << 16))
    return v - 1


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


def _host_refine(qvecs: np.ndarray, cand_vecs: np.ndarray,
                 cand_ids: np.ndarray, valid: np.ndarray, k: int,
                 c2: np.ndarray | None = None):
    """Stage C on the host: exact L2 + top-k via BLAS, same semantics as the
    device refine kernel but no device transfer of candidate vectors.
    ``c2`` (f32 [q, r]) supplies precomputed squared candidate norms (the
    decrypt stage emits them from L1) — skips a full re-read pass."""
    q, r, d = cand_vecs.shape
    dots = np.einsum("qrd,qd->qr", cand_vecs, qvecs, optimize=True)
    if c2 is None:
        cv = cand_vecs.reshape(q * r, d)
        c2 = np.einsum("ij,ij->i", cv, cv).reshape(q, r)
    q2 = np.einsum("ij,ij->i", qvecs, qvecs)
    d2 = c2 - 2.0 * dots + q2[:, None]
    return _topk_from_d2(d2, cand_ids, valid, k)


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
        # reusable decrypt staging and decrypt-and-score outputs (grown on
        # demand): avoids page-faulting fresh candidate-set-sized buffers
        # every batch; rows are masked by `ok`, never read stale
        self._stage_buf = np.zeros(0, np.float32)
        self._norms_buf = np.zeros(0, np.float32)
        self._dots_buf = np.zeros(0, np.float32)

    # -- public ------------------------------------------------------------------

    def search(self, token: QueryToken) -> list[QueryResult]:
        batch = self.search_batch([token])
        with span("query.results"):
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
        with span("query.search_batches"):
            for tokens in list(batches) + [None]:
                current = None
                if tokens:
                    t_start = time.perf_counter()
                    with span("query.token_open") as opened:
                        qvecs = self._decrypt_queries(tokens)
                    # limit=None lets the index pick the per-mode default
                    # (refinement_limit for probe, effective_refinement for
                    # scan)
                    routed = self._dispatch_route(
                        tokens, rt.effective_probes(), None)
                    current = (tokens, qvecs, routed, t_start, opened.ns)
                if pending is not None:
                    res = self._finish_batch(*pending)
                    end = time.perf_counter()
                    start = pending[3] if prev_end is None \
                        else max(pending[3], prev_end)
                    per_q_ns = int((end - start) * 1e9
                                   / max(len(res.stats), 1))
                    for s in res.stats:
                        s.server_ns = per_q_ns
                    prev_end = end
                    results.append(res)
                pending = current
        return results

    def _finish_batch(self, tokens, qvecs, routed, t_start, token_open_ns
                      ) -> BatchSearchResult:
        k = max(t.top_k for t in tokens)
        rt = self.cfg.runtime
        touched_parts: list[np.ndarray] = []
        ids, dists, stats = self._consume_pass(tokens, qvecs, routed, k,
                                               touched_parts, t_start)
        for s in stats:
            s.token_open_ns = token_open_ns // len(tokens)

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
            with span("query.retry"):
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
                    _charge_first_pass(rstats[j], stats[qi])
                    stats[qi] = rstats[j]

        if touched_parts and (self.tracker is not None
                              or self.on_touched is not None):
            # every successfully DECRYPTED candidate is "touched" (reference
            # QueryServiceImpl.java:263 adds each scored id, recorded in the
            # finally block :342-351) — the selective re-encryption set, not
            # merely the returned top-K
            with span("query.track") as tracked:
                touched = np.unique(np.concatenate(touched_parts))
                if self.tracker is not None:
                    self.tracker.record(touched)
                if self.on_touched is not None:
                    self.on_touched(touched)
            for s in stats:
                s.track_ns = tracked.ns // len(stats)
        self.last_stats = stats
        return BatchSearchResult(ids, dists, stats)

    # -- internals ----------------------------------------------------------------

    def _pooled_read(self) -> bool:
        """A ``PointStore`` is read on the host's cores in one native pass
        (``store/parallel_read.py``); any other store, such as the sharded
        store that runs its shards on threads of its own, by its own
        methods."""
        return type(self.store) is PointStore

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
        """Stage A dispatch — returns (routed, copies, width, dispatch_ns,
        packed, events).  On a CUDA scan device this only enqueues work (the
        pipeline overlaps it with the previous batch's host AES); on the CPU
        the scan computes synchronously here and dispatch_ns — charged to
        the route stage — carries its true cost.  ``copies`` holds the
        device→host copies of the ranked id matrix cut to the predicted live
        width (previous batch's, pow2-bucketed), 24-bit packed when
        ``packed``, and of the per-query counters, started now so the
        consume side finds them on the host."""
        # host-side stack: tokens carry numpy codes, and the scan path
        # unpacks them on the host anyway
        qc = np.stack([t.codes for t in tokens])
        qk = np.stack([t.keys for t in tokens])
        # stage A's time on the card, between two events on the current
        # stream, only while a torch.profiler records: read after the
        # copies have landed, so they cost no synchronisation
        events = None
        if _torch_profiler._is_profiler_enabled \
                and self.index.device.type == "cuda":
            stream = torch.cuda.current_stream(self.index.device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        with span("query.dispatch") as dispatched:
            routed = self.index.route_batch(qc, qk, probes, limit)
        if events is not None:
            events[1].record(stream)
        dispatch_ns = dispatched.ns
        # the ranked ids cut to the predicted width, packed, and their copy
        # (and the counters') to the host started
        with span("query.copy_start"):
            r_full = routed.ids.shape[1]
            pred = self._slice_pred
            if pred is not None and pred < 0.7 * r_full:
                ids_slice, width = routed.ids[:, :pred], pred
            else:
                ids_slice, width = routed.ids, r_full
            # 24-bit transfer packing: tensors only (the native path already
            # holds numpy), and the ids must fit the encode
            packed = (isinstance(ids_slice, torch.Tensor)
                      and _pack_transfer_enabled(ids_slice.device)
                      and 0 <= self.index.max_route_id() <= _PACK24_MAX)
            if packed:
                ids_slice = _pack24(ids_slice)
            copies = _HostCopy((ids_slice, routed.n_unique, routed.n_raw,
                                routed.n_dec))
        return routed, copies, width, dispatch_ns, packed, events

    def _consume_pass(self, tokens, qvecs, dispatched, k, touched_parts,
                      t_start):
        routed, copies, pred, dispatch_ns, packed, events = dispatched
        # stage attribution: route_ns counts only the time THIS thread spends
        # blocked on the device result — pipeline overlap (the previous
        # batch's host work ran between dispatch and here) is not charged
        with span("query.wait") as waited:
            # Wait for the copies started at dispatch: the per-query
            # counters and the ranked ids at the PREDICTED live width.  Ids
            # are sorted best-first with pads at the end, so the first
            # max(n_unique) columns carry every live candidate.  On a
            # mispredict (need > pred) fall back to the full matrix —
            # correctness never depends on the prediction.
            ids_slice, n_unique, n_raw, n_dec = copies.get()
            device_ns = None if events is None else \
                int(events[0].elapsed_time(events[1]) * 1e6)
            with span("query.ids"):
                r_full = routed.ids.shape[1]
                # adaptive decrypt budget: only the first n_dec[q] ranked
                # ids are score-competitive — slice/transfer to the batch
                # max and mask the per-query tail so the AES loop never
                # touches it
                width = n_unique if n_dec is None else n_dec
                need = max(int(width.max(initial=1)), k, 1)
                if need <= pred:
                    cand_ids = _unpack24(ids_slice) if packed else ids_slice
                else:   # mispredict: fall back to the full (unpacked) matrix
                    cand_ids = _host(routed.ids)
                self._slice_pred = min(max(256, 1 << (need - 1).bit_length()),
                                       r_full)
                if n_dec is not None:
                    cand_ids = np.where(
                        np.arange(cand_ids.shape[1])[None, :]
                        < n_dec[:, None], cand_ids, -1)

        q, r = cand_ids.shape
        flat = np.ascontiguousarray(cand_ids).reshape(-1)
        dim = self.index.dim
        upload_ns = 0
        if self.cfg.runtime.refine_backend == "device":
            with span("query.decrypt") as decrypted:
                if self._stage_buf.size < flat.size * dim:
                    self._stage_buf = np.zeros(flat.size * dim, np.float32)
                out = self._stage_buf[:flat.size * dim].reshape(flat.size,
                                                                dim)
                # no norms_out: the device refine computes distances from
                # the candidate matrix itself
                if self._pooled_read():
                    vecs_flat, ok_flat = parallel_read.decrypt_batch(
                        self.store, flat, out=out)
                else:
                    vecs_flat, ok_flat = self.store.load_decrypt_batch(
                        flat, out=out)
                valid = ok_flat.reshape(q, r)
                if touched_parts is not None:
                    touched_parts.append(flat[ok_flat])
            with span("query.refine") as refined:
                dev = self.index.device
                with span("refine.upload") as uploaded:
                    inputs = (
                        torch.from_numpy(qvecs).to(dev),
                        torch.from_numpy(vecs_flat.reshape(q, r, dim)).to(dev),
                        torch.from_numpy(cand_ids.astype(np.int32)).to(dev),
                        torch.from_numpy(valid).to(dev))
                upload_ns = uploaded.ns
                with span("refine.compute"):
                    res = refine_ops.refine(*inputs, k)
                with span("refine.download"):
                    # a copy: the retry mutates ids
                    ids = res.ids.cpu().numpy().astype(np.int64)
                    dists = res.distances.cpu().numpy()
                    n_scored = res.n_scored.cpu().numpy()
        else:
            # fused decrypt-and-score: the C AES loop emits per-candidate
            # (norm, query-dot) while each row is in L1 — the plaintext
            # never reaches DRAM, and no candidate matrix exists to re-read
            with span("query.decrypt") as decrypted:
                if self._norms_buf.size < flat.size:
                    self._norms_buf = np.zeros(flat.size, np.float32)
                if self._dots_buf.size < flat.size:
                    self._dots_buf = np.zeros(flat.size, np.float32)
                norms = self._norms_buf[:flat.size]
                dots = self._dots_buf[:flat.size]
                if self._pooled_read():
                    ok_flat = parallel_read.score_batch(self.store, flat,
                                                        qvecs, r, norms, dots)
                else:
                    ok_flat = self.store.load_score_batch(flat, qvecs, r,
                                                          norms, dots)
                valid = ok_flat.reshape(q, r)
                if touched_parts is not None:
                    touched_parts.append(flat[ok_flat])
            with span("query.refine") as refined:
                ids, dists, n_scored = _host_refine_scored(
                    qvecs, dots.reshape(q, r), norms.reshape(q, r), cand_ids,
                    valid, k)

        with span("query.stats"):
            kids = decrypted.children
            lookup_ns = kids.get("store.lookup", 0) // q
            open_ns = kids.get("store.open", 0) // q
            wait_ns = waited.ns // q
            stats = []
            for qi in range(q):
                returned = int((ids[qi] >= 0).sum())
                stats.append(SearchStats(
                    cand_raw=int(n_raw[qi]), cand_unique=int(n_unique[qi]),
                    cand_refined=int((cand_ids[qi] >= 0).sum()),
                    cand_decrypted=int(n_scored[qi]), returned=returned,
                    route_ns=wait_ns + dispatch_ns // q,
                    decrypt_ns=decrypted.ns // q,
                    refine_ns=refined.ns // q,
                    dispatch_ns=dispatch_ns // q, wait_ns=wait_ns,
                    lookup_ns=lookup_ns, open_ns=open_ns,
                    upload_ns=upload_ns // q,
                    stage_a_device_ns=None if device_ns is None
                    else device_ns // q))
        return ids, dists, stats


# per-query times a retried query carries from its first pass
_PASS_FIELDS = ("route_ns", "decrypt_ns", "refine_ns", "dispatch_ns",
                "wait_ns", "lookup_ns", "open_ns", "upload_ns")


def _charge_first_pass(retry: SearchStats, first: SearchStats) -> None:
    """Adds the first pass's times to a retried query's second-pass stats."""
    for f in _PASS_FIELDS:
        setattr(retry, f, getattr(retry, f) + getattr(first, f))
    if first.stage_a_device_ns is not None:
        retry.stage_a_device_ns = first.stage_a_device_ns + (
            retry.stage_a_device_ns or 0)
