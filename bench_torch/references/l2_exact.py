"""Plain reference of an encrypted L2 index: exact top-k by brute force.

Plain PyTorch only; it imports nothing of the program and takes nothing
the program made.  The rows are rounded as the configuration's store keeps
them (``storage``: ``"f16"`` or ``"f32"``), the products run in float32
with TF32 off, and the ``k + EXTRA`` best of each query are scored again by
direct differences in float64 and sorted by (distance, id), so the order is
exact.  Each query sees the rows live when it was issued: ids below its
``live`` count.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

EXTRA = 64          # candidates kept past k before the float64 re-score
CHUNK = 262_144     # rows per block of the float32 product


@contextlib.contextmanager
def _no_tf32():
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = prev


def stored_rows(rows: np.ndarray, storage: str, device) -> torch.Tensor:
    """The rows as the store decodes them, float32 on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)
    if storage == "f16":
        return t.half().float()
    if storage == "f32":
        return t
    raise ValueError(f"no reference rounding for storage {storage!r}")


def distances(rows: torch.Tensor, queries: np.ndarray, ids: np.ndarray
              ) -> np.ndarray:
    """float64 L2 distances [S, k] of ``ids`` (-1 = none: nan) to each
    query, by direct differences."""
    dev = rows.device
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    valid = (ids_t >= 0) & (ids_t < rows.shape[0])
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev).double()
    out = torch.empty(ids_t.shape, dtype=torch.float64, device=dev)
    for s in range(0, len(q), 256):
        x = rows[ids_t[s:s + 256].clamp(0, rows.shape[0] - 1)].double()
        out[s:s + 256] = (x - q[s:s + 256, None, :]).square().sum(-1).sqrt()
    out = torch.where(valid, out, torch.full_like(out, float("nan")))
    return out.cpu().numpy()


def topk(rows: torch.Tensor, queries: np.ndarray, live: np.ndarray, k: int
         ) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-``k``: (ids int64 [S, k], float64 distances [S, k]) of
    each query among the first ``live[s]`` rows of ``rows``."""
    dev = rows.device
    n = rows.shape[0]
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    live_t = torch.from_numpy(np.asarray(live, np.int64)).to(dev)
    qsq = q.square().sum(1)
    kk = k + EXTRA
    best_d = best_i = None
    with _no_tf32():
        for s in range(0, n, CHUNK):
            blk = rows[s:s + CHUNK]
            d2 = blk.square().sum(1)[None, :] - 2.0 * (q @ blk.T) \
                + qsq[:, None]
            col = torch.arange(s, s + len(blk), device=dev)
            d2 = torch.where(col[None, :] < live_t[:, None], d2,
                             torch.full_like(d2, float("inf")))
            v, i = torch.topk(d2, min(kk, len(blk)), dim=1, largest=False)
            i = i + s
            if best_d is not None:
                v, j = torch.topk(torch.cat([best_d, v], 1),
                                  min(kk, best_d.shape[1] + v.shape[1]),
                                  dim=1, largest=False)
                i = torch.cat([best_i, i], 1).gather(1, j)
            best_d, best_i = v, i
    cand = torch.where(torch.isfinite(best_d), best_i,
                       torch.full_like(best_i, -1)).cpu().numpy()
    d = distances(rows, queries, cand)
    d = np.where(np.isnan(d), np.inf, d)
    order = np.lexsort((np.where(cand < 0, np.iinfo(np.int64).max, cand),
                        d), axis=1)[:, :k]
    ids = np.take_along_axis(cand, order, 1)
    dist = np.take_along_axis(d, order, 1)
    ids = np.where(np.isfinite(dist), ids, -1)
    if ids.shape[1] < k:
        pad = k - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        dist = np.pad(dist, ((0, 0), (0, pad)), constant_values=np.inf)
    return ids, dist
