"""Stage-A result type shared by every route.

Only the result container lives here so far: the scan route
(``ops/hamming_scan.py``) returns it.  The multi-probe partition route of
``fspann_tpu/ops/routing.py`` is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_INF = int(np.iinfo(np.int32).max)


class RouteResult(NamedTuple):
    """Fields are torch tensors on the scan device, or numpy arrays once
    mapped to external ids on the host (``PartitionedIndex._map_external``)."""

    ids: torch.Tensor       # int32 [Q, R] candidate ids ranked by score, -1 = pad
    scores: torch.Tensor    # int32 [Q, R] Hamming score per id, _INF = pad
    n_unique: torch.Tensor  # int32 [Q] unique live candidates found
    n_raw: torch.Tensor     # int32 [Q] raw ids touched (scan: every row)
    # int32 [Q] per-query adaptive decrypt budget (scan mode only, None
    # when disabled): how many of the ranked ids are score-competitive —
    # within ``adaptive_decrypt_margin`` Hamming bits of the anchor-th
    # best.  The host decrypts only ids[:n_dec[q]] per query.
    n_dec: torch.Tensor | None = None
