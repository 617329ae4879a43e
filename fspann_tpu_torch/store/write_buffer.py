"""Buffered inserter: accumulate single inserts into store-sized batches.

Reference counterpart: ``common/EncryptedPointBuffer.java`` — a per-version
write buffer with a flush threshold and heap backpressure (:44-68).  The
reference's instance is vestigial (``getPointBuffer()`` returns null,
PartitionedIndexService.java:856-858); here the buffer is live: the facade's
single-point ``insert`` path lands in it so per-point calls amortize into
the same batched seal + arena append as bulk ingestion.
"""

from __future__ import annotations

import numpy as np


class BufferedInserter:
    def __init__(self, sink, dim: int, flush_threshold: int = 4096,
                 max_buffered_bytes: int = 64 << 20):
        """``sink(ids, vecs)`` performs the actual batched insert.

        Backpressure is both count- and BYTES-based (reference
        EncryptedPointBuffer flushes at 80% heap, :44-68): on a host where
        vectors are wide (e.g. 960-d GIST) the count threshold alone would
        let the staging list grow unbounded relative to memory."""
        self.sink = sink
        self.dim = dim
        self.flush_threshold = flush_threshold
        self.max_buffered_bytes = max_buffered_bytes
        self._ids: list[int] = []
        self._vecs: list[np.ndarray] = []
        self._bytes = 0

    def add(self, point_id: int, vec: np.ndarray) -> None:
        vec = np.asarray(vec, np.float32)
        if vec.shape != (self.dim,):
            raise ValueError(f"expected [{self.dim}] vector, got {vec.shape}")
        self._ids.append(int(point_id))
        self._vecs.append(vec)
        self._bytes += vec.nbytes
        if (len(self._ids) >= self.flush_threshold
                or self._bytes >= self.max_buffered_bytes):
            self.flush()

    def __len__(self) -> int:
        return len(self._ids)

    def flush(self) -> int:
        if not self._ids:
            return 0
        ids = np.array(self._ids, np.int64)
        vecs = np.stack(self._vecs)
        self._ids.clear()
        self._vecs.clear()
        self._bytes = 0
        self.sink(ids, vecs)
        return len(ids)
