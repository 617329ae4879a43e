"""Brute-force exact L2 top-K: the plain torch twin of the L2 top-k kernel.

Reference behavior (api/GroundtruthPrecompute.java): exact top-K over the
whole base.  Chunked ``|x|^2 - 2 q·x`` with a float32 ``torch.matmul`` (TF32
off, set explicitly for the call), a per-chunk top-K in ``(d², id)`` order
and a running merge.  ``ops/l2_topk.l2_topk`` uses this for CPU tensors and
``chip_smoke.py`` holds the CUDA kernel to it on the card.

Device refine of decrypted candidates (``refine_backend="device"``) is not
ported yet; the serving path scores on the host (query/service.py).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 products in full float32 on CUDA (TF32 off) for the block."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def _sortable(d2: torch.Tensor) -> torch.Tensor:
    """float32 → int32 whose signed order is the float order (non-NaN);
    the map is its own inverse."""
    i = d2.view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _pair_topk(key: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(key, k, dim=1, largest=False, sorted=True).values


def bruteforce_topk(base: torch.Tensor | np.ndarray,
                    qvecs: torch.Tensor | np.ndarray, k: int,
                    chunk: int = 262_144, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-K over the whole base, chunked over N to bound memory.

    Returns ``(ids int32 [Q, K], distances f32 [Q, K])`` with true L2
    (sqrt) on ``device`` (default: the device of ``qvecs`` when it is a
    tensor, else the CPU), ordered by ``(|x|^2 - 2 q·x, id)`` ascending.
    ``base`` may be a numpy array; chunks move to the device on demand.
    """
    if device is None:
        device = qvecs.device if isinstance(qvecs, torch.Tensor) else "cpu"
    q = torch.as_tensor(qvecs, dtype=torch.float32).to(device)
    qsq = (q * q).sum(dim=-1)
    n = base.shape[0]
    k = min(k, n)
    best = None
    with full_fp32_matmul():
        for s in range(0, n, chunk):
            blk = torch.as_tensor(base[s:s + chunk],
                                  dtype=torch.float32).to(device)
            d2 = (blk * blk).sum(dim=-1)[None, :] - 2.0 * (q @ blk.T)
            ids = torch.arange(s, s + blk.shape[0], dtype=torch.int64,
                               device=device)
            # one int64 key per (d², id): unique, so the order is exact
            key = (_sortable(d2).to(torch.int64) << 32) | ids
            key = _pair_topk(key, min(k, blk.shape[0]))
            best = key if best is None else _pair_topk(
                torch.cat([best, key], dim=1), k)
    d2 = _sortable((best >> 32).to(torch.int32)).view(torch.float32)
    dist = torch.sqrt(torch.clamp(d2 + qsq[:, None], min=0.0))
    return (best & 0xFFFFFFFF).to(torch.int32), dist
