"""Greedy partition construction (reference "Algorithm-2") as device sorts.

Port of ``fspann_tpu/ops/partition.py``.  Reference behavior
(index/paper/GreedyPartitioner.java:37-76): per (table, division) group,
sort all (id, 63-bit key) pairs by key, chop into fixed blocks of
``blockSize``, and record per block {minKey, maxKey, repCode = median
element's code, ids}.

All G groups build in one batched ``torch.sort`` over ``[G, N]``.  The JAX
package sorts the (key, id) pair with a two-key ``lax.sort``; the ids start
as ``arange``, so a STABLE sort by key alone gives exactly that order.
Wide keys sort by ``key2`` first and then, stably, by ``key`` (LSD order),
which gives the (key, key2, id) order of the three-key sort.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import threads
from . import coding

INT64_MAX = int(np.iinfo(np.int64).max)


class PartitionTable(NamedTuple):
    """Dense partition layout for all groups.

    ``P = ceil(N / block)`` partitions per group; the final partition of each
    group may be partial (``counts`` < block) and is padded with id ``-1`` /
    key ``INT64_MAX``.  Fields are torch tensors (device build, or
    :func:`table_to`), or numpy arrays from :func:`build_partitions_numpy`
    with ``rep_codes`` as uint32, the JAX package's host layout.
    """

    min_key: torch.Tensor    # int64 [G, P]
    max_key: torch.Tensor    # int64 [G, P]
    rep_codes: torch.Tensor  # int32 bit patterns [G, P, W]  median's code
    ids: torch.Tensor        # int32 [G, P, B]   vector ids, -1 = pad
    counts: torch.Tensor     # int32 [G, P]      valid ids per block
    # wide-key mode (``build_partitions(wide=True)``): secondary 63-bit key
    # boundaries carrying code bits 63..125 (coding.keys2_from_codes).
    # None => reference-exact narrow order.
    min_key2: torch.Tensor | None = None   # int64 [G, P]
    max_key2: torch.Tensor | None = None   # int64 [G, P]

    @property
    def num_groups(self) -> int:
        return self.ids.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.ids.shape[1]

    @property
    def block_size(self) -> int:
        return self.ids.shape[2]


def table_to(table: PartitionTable, device) -> PartitionTable:
    """The table as tensors on ``device``; numpy fields are converted
    (uint32 rep codes become int32 bit patterns)."""
    def t(a):
        if a is None:
            return None
        if isinstance(a, np.ndarray):
            a = coding.words_to_torch(a) if a.dtype == np.uint32 \
                else torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device)
    return PartitionTable(*(t(f) for f in table))


def table_to_numpy(table: PartitionTable) -> PartitionTable:
    """Host (numpy) twin of a tensor table in the JAX package's layout
    (rep codes as uint32)."""
    def n(a):
        if a is None or isinstance(a, np.ndarray):
            return a
        return a.cpu().numpy()
    t = PartitionTable(*(n(f) for f in table))
    return t._replace(rep_codes=np.ascontiguousarray(t.rep_codes)
                      .view(np.uint32))


def build_partitions(keys: torch.Tensor, codes: torch.Tensor,
                     block_size: int = 64,
                     wide: bool = False) -> PartitionTable:
    """Build the partition table for all groups at once, on the inputs'
    device.

    Args:
      keys:  int64 ``[G, N]`` sortable routing keys (coding.keys_from_codes).
      codes: int32 ``[G, N, W]`` packed code bit patterns (for repCodes).
      block_size: ids per partition (reference uses 64,
        PartitionedIndexService.java:412-425).
      wide: order by the (key, key2) pair — the full code-prefix order up
        to 126 bits (``runtime.wide_keys``) — instead of the reference's
        63-bit truncated order.
    """
    g, n = keys.shape
    b = block_size
    p = -(-n // b)
    pad = p * b - n
    dev = keys.device

    skeys2 = None
    if wide:
        keys2 = coding.keys2_from_codes(codes)                   # [G, N]
        # LSD: stable by the minor key, then stable by the major key
        order = torch.sort(keys2, dim=-1, stable=True).indices
        by_key = torch.sort(keys.gather(1, order), dim=-1,
                            stable=True).indices
        order = order.gather(1, by_key)
        skeys2 = keys2.gather(1, order)
        skeys = keys.gather(1, order)
    else:
        # ties in key break by id (the ids are arange): deterministic
        skeys, order = torch.sort(keys, dim=-1, stable=True)
    sids = order.to(torch.int32)
    if pad:
        skeys = torch.nn.functional.pad(skeys, (0, pad), value=INT64_MAX)
        sids = torch.nn.functional.pad(sids, (0, pad), value=-1)
        if skeys2 is not None:
            skeys2 = torch.nn.functional.pad(skeys2, (0, pad),
                                             value=INT64_MAX)

    skeys = skeys.reshape(g, p, b)
    sids = sids.reshape(g, p, b)

    # Valid count per block: only the final block can be partial.
    base = torch.arange(p, dtype=torch.int64, device=dev) * b
    counts = torch.clamp(n - base, 0, b).to(torch.int32)
    counts = counts.expand(g, p).contiguous()

    last = torch.clamp(counts - 1, min=0).to(torch.int64)[..., None]
    min_key = skeys[:, :, 0].contiguous()
    max_key = skeys.gather(2, last)[..., 0]
    min_key2 = max_key2 = None
    if skeys2 is not None:
        skeys2 = skeys2.reshape(g, p, b)
        min_key2 = skeys2[:, :, 0].contiguous()
        max_key2 = skeys2.gather(2, last)[..., 0]

    # repCode = code of the median element of the block (ref :60-70).
    mid = ((counts - 1) // 2).to(torch.int64)[..., None]
    mid_ids = sids.gather(2, mid)[..., 0]                         # [G, P]
    safe_mid = torch.clamp(mid_ids, min=0).to(torch.int64)
    garange = torch.arange(g, device=dev)[:, None]
    rep_codes = codes[garange, safe_mid]                          # [G, P, W]
    # Degenerate (empty input) blocks keep zero codes.
    rep_codes = torch.where((mid_ids >= 0)[..., None], rep_codes,
                            torch.zeros_like(rep_codes))
    return PartitionTable(min_key, max_key, rep_codes, sids, counts,
                          min_key2, max_key2)


def build_partitions_numpy(keys: "np.ndarray", codes: "np.ndarray",
                           block_size: int = 64, wide: bool = False,
                           width: int = 1) -> PartitionTable:
    """Host-side build with the same layout/semantics as
    :func:`build_partitions` (ties break by id); the result is a table of
    numpy arrays (``codes`` and ``rep_codes`` uint32) ready for one
    :func:`table_to`.  The G groups sort on ``width`` host threads.
    ``keys`` [G, N] and ``codes`` [G, N, W] may be strided views of the
    point-major arrays: each group's keys are read by its own sort, and of
    the codes only each block's middle row is gathered (with ``wide``, the
    words of the second key are read too)."""
    g, n = keys.shape
    b = block_size
    p = -(-n // b)
    pad = p * b - n
    ids0 = np.arange(n, dtype=np.int32)

    keys2 = coding.keys2_from_codes_numpy(codes) if wide else None  # [G, N]
    skeys = np.empty((g, p * b), np.int64)
    sids = np.empty((g, p * b), np.int32)
    skeys2 = np.empty((g, p * b), np.int64) if wide else None

    def sort_group(gi: int) -> None:
        if wide:
            order = np.lexsort((ids0, keys2[gi], keys[gi]))
            skeys2[gi, :n] = keys2[gi][order]
        else:
            order = np.lexsort((ids0, keys[gi]))
        skeys[gi, :n] = keys[gi][order]
        sids[gi, :n] = ids0[order]

    # the groups' sorts and gathers are independent (numpy releases the
    # interpreter lock inside them): one host thread a group at a time
    threads.map_threads(sort_group, range(g), min(g, width))
    if pad:
        skeys[:, n:] = np.iinfo(np.int64).max
        sids[:, n:] = -1
        if wide:
            skeys2[:, n:] = np.iinfo(np.int64).max
    skeys = skeys.reshape(g, p, b)
    sids = sids.reshape(g, p, b)

    counts = np.clip(np.int64(n) - np.arange(p, dtype=np.int64) * b, 0, b
                     ).astype(np.int32)
    counts = np.broadcast_to(counts, (g, p)).copy()
    min_key = skeys[:, :, 0].copy()
    last = np.maximum(counts - 1, 0)
    max_key = np.take_along_axis(skeys, last[..., None], axis=-1)[..., 0]
    min_key2 = max_key2 = None
    if wide:
        skeys2 = skeys2.reshape(g, p, b)
        min_key2 = skeys2[:, :, 0].copy()
        max_key2 = np.take_along_axis(skeys2, last[..., None], axis=-1)[..., 0]
    mid = (counts - 1) // 2
    mid_ids = np.take_along_axis(sids, mid[..., None], axis=-1)[..., 0]
    safe_mid = np.maximum(mid_ids, 0)
    rep_codes = codes[np.arange(g)[:, None], safe_mid]
    rep_codes = np.where((mid_ids >= 0)[..., None], rep_codes, 0
                         ).astype(np.uint32)
    return PartitionTable(min_key, max_key, rep_codes, sids, counts,
                          min_key2, max_key2)
