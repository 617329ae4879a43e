"""Multi-probe candidate generation (stage A of ``routing_mode="probe"``).

Port of ``fspann_tpu/ops/routing.py``.  Reference behavior
(index/paper/PartitionedIndexService.java:592-715): per (table, division)
group, locate the partition whose key range contains the query key (binary
search + closest-boundary fallback,
GreedyPartitioner.findNearestPartition:101-124), then run a best-first probe
over partitions ordered by Hamming(query code, partition repCode), expanding
left/right neighbors, for ``maxProbes`` partitions; collect ids scoring each
with its partition's repCode Hamming, dedupe keeping the minimum score, sort
ascending, and cap.

Because partitions form a line and expansion only enqueues the two outer
neighbors of the probed interval, the probed set is a contiguous interval
around the center, and the walk repeatedly extends toward whichever frontier
has the smaller repCode Hamming: a fixed-length loop over ``[Q, G]``
tensors.  The JAX module's two documented deviations from the reference
(globally best-scored candidates kept at the cap; stage A.5 as the
score-ranked truncation) hold here too.

Order contracts (bit for bit with the JAX package):
* ``torch.topk`` does not keep the lower index first on ties and
  ``torch.sort`` takes one key, so every multi-key sort of the JAX module
  runs on ONE int64 key: the dedup's (id, score) as ``(id << 32) | score``,
  the ranking's (score, id) as ``(score << 32) | id``, and the re-rank's
  (fine, id) as ``(fine << 32) | id``.  Ids and scores are non-negative
  int32 (pads INT32_MAX), so each key orders exactly like its pair.
* Device codes are int32 bit patterns (``coding.words_to_torch``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import coding
from .approx_topk import _DEAD, approx_rank_topk
from .code_hamming import code_hamming
from .hamming import hamming
from .partition import PartitionTable

INT32_MAX = int(np.iinfo(np.int32).max)
_INF = INT32_MAX
_LOW32 = 0xFFFFFFFF
_SIGN64 = -2 ** 63


class RouteResult(NamedTuple):
    """Fields are torch tensors on the routing device, or numpy arrays once
    mapped to external ids on the host (``PartitionedIndex._map_external``)
    or when the native host scan served the route (``ops/native_scan``)."""

    ids: torch.Tensor       # int32 [Q, R] candidate ids ranked by score, -1 = pad
    scores: torch.Tensor    # int32 [Q, R] Hamming score per id, _INF = pad
    n_unique: torch.Tensor  # int32 [Q] unique live candidates found
    n_raw: torch.Tensor     # int32 [Q] raw (pre-dedup) ids touched
    # int32 [Q] per-query adaptive decrypt budget (scan mode only, None
    # when disabled): how many of the ranked ids are score-competitive —
    # within ``adaptive_decrypt_margin`` Hamming bits of the anchor-th
    # best.  The host decrypts only ids[:n_dec[q]] per query.
    n_dec: torch.Tensor | None = None


def _full(like: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full_like(like, value)


def find_center(table: PartitionTable, qkeys: torch.Tensor,
                qkeys2: torch.Tensor | None = None) -> torch.Tensor:
    """Containing-or-closest partition per (query, group).

    ``qkeys``: int64 [Q, G] → int32 [Q, G] partition index.
    ``below`` (count of blocks entirely below the key) is the binary-search
    insertion point; then containment test, else closest flanking range.
    Narrow keys search with ``torch.searchsorted`` (``max_key`` is sorted
    per group).  With a wide table and ``qkeys2`` every comparison is over
    the lexicographic (key, key2) pair, searched by the JAX module's
    fixed-length binary search.
    """
    wide = table.min_key2 is not None and qkeys2 is not None
    g, p = table.min_key.shape
    garange = torch.arange(g, device=qkeys.device)[None]           # [1, G]

    def pair_ge(a1, a2, b1, b2):
        if not wide:
            return a1 >= b1
        return (a1 > b1) | ((a1 == b1) & (a2 >= b2))

    if wide:
        lo = torch.zeros(qkeys.shape, dtype=torch.int64, device=qkeys.device)
        hi = _full(lo, p)
        for _ in range(max(1, (p + 1).bit_length())):
            mid = (lo + hi) // 2
            c = torch.clamp(mid, max=p - 1)
            ge = pair_ge(table.max_key[garange, c], table.max_key2[garange, c],
                         qkeys, qkeys2)
            lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
        below = lo
    else:
        below = torch.searchsorted(table.max_key, qkeys.T.contiguous(),
                                   side="left").T
    c0 = torch.clamp(below, max=p - 1)
    min_c0 = table.min_key[garange, c0]                            # [Q, G]
    min2_c0 = table.min_key2[garange, c0] if wide else None
    inside = (below < p) & pair_ge(qkeys, qkeys2, min_c0, min2_c0)

    # the JAX search can end one past p; its gather clamps, this one is
    # clamped explicitly (the fallback below picks p - 1 either way)
    left = torch.clamp(below - 1, 0, p - 1)
    max_left = table.max_key[garange, left]
    if wide:
        # closest flanking range under the 126-bit combined value:
        # |d| = d1*2^63 + d2 with both segments 63-bit non-negative; after
        # a borrow-normalization (d2 < 0 → d1-1, d2+2^63 — the +2^63 is an
        # int64 sign-bit flip) the pair compares lexicographically exactly.
        max2_left = table.max_key2[garange, left]

        def pair_diff(a1, a2, b1, b2):
            d1 = a1 - b1
            d2 = a2 - b2
            borrow = d2 < 0
            return (torch.where(borrow, d1 - 1, d1),
                    torch.where(borrow, d2 ^ _SIGN64, d2))

        dl1, dl2 = pair_diff(qkeys, qkeys2, max_left, max2_left)
        dr1, dr2 = pair_diff(min_c0, min2_c0, qkeys, qkeys2)
        dl_le = (dl1 < dr1) | ((dl1 == dr1) & (dl2 <= dr2))
    else:
        dl_le = (qkeys - max_left) <= (min_c0 - qkeys)
    mid = torch.where(dl_le, left, c0)
    fallback = torch.where(below <= 0, torch.zeros_like(mid),
                           torch.where(below >= p, _full(mid, p - 1), mid))
    return torch.where(inside, c0, fallback).to(torch.int32)


def _greedy_interval(ham_w: torch.Tensor, max_probes: int):
    """Greedy frontier walk over the probe window.

    ``ham_w``: int32 [..., V] window Hamming scores (INF marks out-of-range),
    window center at index ``max_probes - 1``.  Returns ``(lo, hi)`` int32
    [...] — the probed interval's window coordinates (≤ max_probes wide).
    Ties go left (``hl <= hr``).
    """
    v = ham_w.shape[-1]
    c = max_probes - 1
    lo = torch.full(ham_w.shape[:-1], c, dtype=torch.int64,
                    device=ham_w.device)
    hi = lo.clone()
    inf = _full(lo, _INF).to(ham_w.dtype)
    for _ in range(max_probes - 1):
        hl = torch.where(lo - 1 >= 0, ham_w.gather(
            -1, torch.clamp(lo - 1, min=0)[..., None])[..., 0], inf)
        hr = torch.where(hi + 1 <= v - 1, ham_w.gather(
            -1, torch.clamp(hi + 1, max=v - 1)[..., None])[..., 0], inf)
        both_dead = (hl == _INF) & (hr == _INF)
        go_left = (hl <= hr) & ~both_dead
        go_right = (hr < hl) & ~both_dead
        lo = torch.where(go_left, lo - 1, lo)
        hi = torch.where(go_right, hi + 1, hi)
    return lo.to(torch.int32), hi.to(torch.int32)


def _route_dedup(table: PartitionTable, qcodes: torch.Tensor,
                 qkeys: torch.Tensor, tombstones: torch.Tensor,
                 max_probes: int, need_scores: bool = True):
    """Shared front half of the route: probe walk → gather → dedup.

    Returns ``(sid, sscore, n_unique, n_raw)`` where ``sid``/``sscore`` are
    the flat probed candidates sorted by (id, score) with duplicates and
    pads masked to INT32_MAX/_INF — i.e. id-ascending among the live
    entries.  ``need_scores=False`` sorts the ids alone and returns
    ``sscore=None``.
    """
    q, g, w = qcodes.shape
    p = table.num_partitions
    v = 2 * max_probes - 1
    dev = qcodes.device
    garange = torch.arange(g, device=dev)[None, :, None]          # [1, G, 1]

    # wide-key tables carry bits 63..125 boundaries; the matching query
    # secondary keys derive from the codes already in hand
    qkeys2 = coding.keys2_from_codes(qcodes) \
        if table.min_key2 is not None else None
    center = find_center(table, qkeys, qkeys2).to(torch.int64)   # [Q, G]
    offs = torch.arange(-(max_probes - 1), max_probes, dtype=torch.int64,
                        device=dev)
    widx_raw = center[..., None] + offs                           # [Q, G, V]
    in_range = (widx_raw >= 0) & (widx_raw < p)
    widx = torch.clamp(widx_raw, 0, p - 1)

    # Window repCodes + Hamming scores (gathers, no [Q,G,P,*] materialization).
    rep_w = table.rep_codes[garange, widx]                        # [Q, G, V, W]
    ham_w = hamming(qcodes[:, :, None, :], rep_w)                 # [Q, G, V]
    ham_w = torch.where(in_range, ham_w, _full(ham_w, _INF))

    lo, hi = _greedy_interval(ham_w, max_probes)                  # [Q, G]

    # Gather exactly the probed interval's blocks (≤ max_probes of them).
    woff = lo.to(torch.int64)[..., None] + torch.arange(
        max_probes, dtype=torch.int64, device=dev)                # [Q,G,Pr]
    in_probe = woff <= hi[..., None]
    woff_c = torch.clamp(woff, 0, v - 1)
    pidx = widx.gather(-1, woff_c)                                # [Q, G, Pr]
    ham_p = ham_w.gather(-1, woff_c)
    in_probe &= ham_p < _INF

    cand_ids = table.ids[garange, pidx]                           # [Q,G,Pr,B]
    alive = cand_ids >= 0
    dead = tombstones[torch.clamp(cand_ids, min=0).to(torch.int64)] & alive
    valid = in_probe[..., None] & alive & ~dead

    flat_ids = torch.where(valid, cand_ids, _full(cand_ids, INT32_MAX)
                           ).reshape(q, -1)
    n_raw = valid.reshape(q, -1).sum(dim=-1, dtype=torch.int32)

    # Dedupe keeping min score: sort by (id, score); first of each id-run wins.
    if need_scores:
        flat_scores = torch.where(valid, ham_p[..., None].expand_as(valid),
                                  _full(ham_p, _INF)[..., None]
                                  ).reshape(q, -1)
        key = (flat_ids.to(torch.int64) << 32) | flat_scores.to(torch.int64)
        key = torch.sort(key, dim=-1).values
        sid = (key >> 32).to(torch.int32)
        sscore = (key & _LOW32).to(torch.int32)
    else:
        sid = torch.sort(flat_ids, dim=-1).values
        sscore = None
    first = torch.ones_like(sid, dtype=torch.bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    live = first & (sid != INT32_MAX)
    n_unique = live.sum(dim=-1, dtype=torch.int32)
    sid = torch.where(live, sid, _full(sid, INT32_MAX))
    if need_scores:
        sscore = torch.where(live, sscore, _full(sscore, _INF))
    return sid, sscore, n_unique, n_raw


def route(table: PartitionTable, qcodes: torch.Tensor, qkeys: torch.Tensor,
          tombstones: torch.Tensor, max_probes: int,
          refinement_limit: int) -> RouteResult:
    """Stage A for a batch of queries: candidate ids ranked by Hamming score.

    Args:
      table: built PartitionTable (all groups), tensors on the device.
      qcodes: int32 [Q, G, W] packed query code bit patterns.
      qkeys: int64 [Q, G] query sort keys.
      tombstones: bool [N] deleted-id mask (device-resident; reference checks
        ``metadata.isDeleted`` per id, PartitionedIndexService.java:726-753).
      max_probes: partitions probed per group (effectiveMaxProbes).
      refinement_limit: R — ranked candidates returned per query.
    """
    sid, sscore, n_unique, n_raw = _route_dedup(table, qcodes, qkeys,
                                                tombstones, max_probes)
    # Final ranking by (score, id); truncate to R.
    key = torch.sort((sscore.to(torch.int64) << 32) | sid.to(torch.int64),
                     dim=-1).values
    r = min(refinement_limit, key.shape[-1])
    key = key[:, :r]
    rscore = (key >> 32).to(torch.int32)
    rid = (key & _LOW32).to(torch.int32)
    rid = torch.where(rid == INT32_MAX, _full(rid, -1), rid)
    return RouteResult(rid, rscore, n_unique, n_raw)


def route_rerank(table: PartitionTable, qcodes: torch.Tensor,
                 qkeys: torch.Tensor, tombstones: torch.Tensor,
                 point_codes: torch.Tensor, max_probes: int, limit: int,
                 approx: bool = False) -> RouteResult:
    """Fused stage A + full-code rerank: one top-k instead of two sorts.

    Equivalent to ``rerank(point_codes, qcodes, route(...), limit)`` when
    the route's refinement_limit does not truncate (and a strict superset
    of its candidate pool otherwise): the coarse (score, id) ranking is
    skipped and the fine scores (``ops/code_hamming``, the CUDA kernel on
    the card) of the deduped candidates are truncated in (fine, id) order.

    ``point_codes``: int32 [N, G, W] (or [N, G·W]) code bit patterns in
    dense row order.  ``approx=True`` truncates with
    ``approx_topk.approx_rank_topk`` (the TPU's ``approx_max_k``), binned
    over each candidate's position in the deduped array, as the JAX
    package's index is.
    """
    q, g, w = qcodes.shape
    sid, _, n_unique, n_raw = _route_dedup(table, qcodes, qkeys,
                                           tombstones, max_probes,
                                           need_scores=False)
    pc = point_codes.reshape(point_codes.shape[0], g * w)
    # live ids ascend with their column: the kernel may sweep the codes in
    # row order, and (fine, id) is the lower-index-first order of
    # lax.top_k; pads (fine and id INT32_MAX) rank last
    fine = code_hamming(pc, qcodes.reshape(q, g * w).contiguous(), sid,
                        ascending=True)
    k = min(limit, sid.shape[-1])
    if approx:
        # pads take the JAX package's 2^30 sentinel (its f32-exact stand-in
        # for INT32_MAX), which still ranks after every real score
        fa = torch.where(sid != INT32_MAX, fine, _full(fine, _DEAD))
        score, col = approx_rank_topk(fa, k)
        rid = sid.gather(1, col.to(torch.int64))
    else:
        key = torch.topk((fine.to(torch.int64) << 32) | sid.to(torch.int64),
                         k, dim=-1, largest=False, sorted=True).values
        score = (key >> 32).to(torch.int32)
        rid = (key & _LOW32).to(torch.int32)
    pad = rid == INT32_MAX
    score = torch.where(pad, _full(score, _INF), score)
    rid = torch.where(pad, _full(rid, -1), rid)
    return RouteResult(rid, score, torch.clamp(n_unique, max=k), n_raw)


def rerank(point_codes: torch.Tensor, qcodes: torch.Tensor, res: RouteResult,
           limit: int) -> RouteResult:
    """Full-code re-rank: truncate the routed set by exact code Hamming.

    Re-scores each candidate by the Hamming distance between the query's
    and the candidate's own packed codes summed across all groups and keeps
    the best ``limit`` in (fine, id) order — the per-candidate refinement of
    the reference's stage-A.5 prefilter (QueryServiceImpl.java:167-214).

    Args:
      point_codes: int32 [N, G, W] (or [N, G·W]) code bit patterns.
      qcodes: int32 [Q, G, W] packed query codes.
      res: ranked output of :func:`route` (ids are row indices, -1 pad).
      limit: decrypt budget L — ids kept per query after re-ranking.
    """
    q, g, w = qcodes.shape
    rid = res.ids.to(torch.int32).contiguous()
    pc = point_codes.reshape(point_codes.shape[0], g * w)
    fine = code_hamming(pc, qcodes.reshape(q, g * w).contiguous(), rid)
    # pads: fine INT32_MAX and id -1 (all ones in the low half) rank last
    key = torch.sort((fine.to(torch.int64) << 32)
                     | (rid.to(torch.int64) & _LOW32), dim=-1).values
    r = min(limit, rid.shape[-1])
    key = key[:, :r]
    low = key & _LOW32
    fid = torch.where(low == _LOW32, _full(low, -1), low).to(torch.int32)
    return RouteResult(fid, (key >> 32).to(torch.int32),
                       torch.clamp(res.n_unique, max=r), res.n_raw)
