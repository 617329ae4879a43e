"""The query service's touched set: which ids the re-encryption tracker
already holds since its last drain.

Every id a batch decrypts is "touched" and must reach the
``ReencryptionTracker`` (reference QueryServiceImpl.java:342-351).  Recording
each batch whole (``np.unique`` of ~100,000 ids, then an int64 copy kept
until the next drain) makes the serving thread sort every batch and the
tracker retain one copy of every batch.  :class:`TouchedMap` keeps one
byte per id instead: a batch's ids are looked up in the map, only those not
yet marked are marked and forwarded, so the tracker receives each distinct
id once between drains and the drained set is the one a whole-batch record
would give.
"""

from __future__ import annotations

import numpy as np

from ..utils.profiler import count

# largest map, in bytes per live row of the index: ids sparser than this
# are recorded batch by batch, as without the map
BYTES_PER_ROW = 4


class TouchedMap:
    """A dense byte map over the id space, allocated once at the index's
    live row count and grown by doubling when larger ids arrive: byte ``i``
    is 1 when id ``i`` went to the tracker after its last drain.

    The tracker is drained by its owners directly (the facades'
    ``run_selective_reencryption``), so the map notices a drain itself: it
    keeps the tracker's list of recorded parts as it was after the map's
    last record and clears its marks when that list is another object.
    ``ReencryptionTracker.drain`` replaces the list, and so does the
    compaction inside ``unique_count``; a compaction is treated as a drain,
    which re-records ids the tracker holds already and leaves its set as it
    was.  This reads a private field of the tracker, a carried class whose
    code ``tests/test_torch_isolation.py`` holds equal to its JAX source."""

    def __init__(self):
        self._marks = np.zeros(0, np.uint8)
        self._flags = np.zeros(0, np.uint8)     # gathered marks, reused
        self._fresh = np.zeros(0, np.bool_)     # unmarked, reused
        self._tracker = None
        self._tracker_parts = None   # the tracker's list after our record

    def record(self, parts: list[np.ndarray], tracker, rows: int) -> bool:
        """Forwards to ``tracker`` the ids of ``parts`` that it does not
        hold since its last drain.  Returns False, recording nothing, where
        the ids are not dense enough for the map: a negative id, or a
        largest id past ``BYTES_PER_ROW`` times ``rows``, the index's live
        row count.  The largest id is the batch's own, not the index's
        ``max_route_id()``, which is a pass over a non-dense index's ids."""
        parts = [p for p in parts if len(p)]
        if not parts:
            return True
        lo = min(int(p.min()) for p in parts)
        hi = max(int(p.max()) for p in parts)
        cap = BYTES_PER_ROW * rows
        if lo < 0 or hi >= cap:
            return False
        if hi >= len(self._marks):
            grown = np.zeros(
                min(max(hi + 1, 2 * len(self._marks), rows), cap), np.uint8)
            grown[:len(self._marks)] = self._marks
            self._marks = grown
        marks = self._marks
        before = tracker._parts
        if tracker is not self._tracker or before is not self._tracker_parts:
            marks[:] = 0
        longest = max(len(p) for p in parts)
        if len(self._flags) < longest:
            self._flags = np.zeros(2 * longest, np.uint8)
            self._fresh = np.zeros(2 * longest, np.bool_)
        fresh = []
        for p in parts:
            n = len(p)
            # mode="clip" gathers straight into ``out`` (``"raise"`` would
            # buffer); every id is inside the map
            flags = np.take(marks, p, out=self._flags[:n], mode="clip")
            new = p[np.equal(flags, 0, out=self._fresh[:n])]
            if len(new):
                marks[new] = 1
                fresh.append(new)
        n_fresh = 0
        if fresh:
            new = np.unique(np.concatenate(fresh))
            tracker.record(new)
            n_fresh = len(new)
        self._tracker = tracker
        if tracker._parts is before:
            self._tracker_parts = before
        else:
            # drained or compacted while this batch was marked: ids marked
            # before may have left with the drain, so the batch goes in
            # whole, and the marks are cleared at the next batch
            tracker.record(np.unique(np.concatenate(parts)))
            self._tracker_parts = None
        count("query.track.ids", sum(len(p) for p in parts))
        count("query.track.fresh", n_fresh)
        return True
