"""Approximate top-k selection: the counterpart of ``lax.approx_max_k``, whose
reduction step is a hand-written CUDA kernel (``csrc/approx_topk.cu``).

The JAX package selects the scan's top-L with ``jax.lax.approx_max_k(-part,
k, recall_target=0.98)`` (``fspann_tpu/ops/hamming_scan.py:212`` and
``:252``, ``ops/routing.py:297``, ``parallel/sharded.py:688``).  On the TPU
that lowers to the ``ApproxTopK`` custom call: a PartialReduce that keeps
the best element of each of ``W`` strided bins, then an exact top-k of the
``W`` survivors (Chern et al., "TPU-KNN", 2022).  Every other XLA backend
sorts and slices, which is exact.  This module defines the selection as
follows, for a row of length ``N``:

1. ``(W, r) = reduction_output_size(N, k, recall_target)``, XLA's
   ``ApproxTopKReductionOutputSize``.  With ``r == 0`` nothing is reduced
   and the result is the exact top-k.
2. Element ``i`` goes to bin ``i mod W``; each bin keeps its least ``(value,
   i)`` pair as one int64 key ``(value << 32) | (row0 + i)``, and an empty
   bin holds INT64_MAX (none is ever selected: ``W >= k``).
3. The exact top-k of the ``W`` bin minima in key order.

A row may be the last ``C`` columns of a wider block whose first ``off``
columns are dead (``_DEAD``): the chunked scan's tail, which the JAX package
scans as a whole ``chunk``-row block with the rows it already scanned masked
dead.  Then ``(W, r)`` come from the block's width ``C + off`` and column
``i`` goes to bin ``(i + off) mod W``; the dead front is never read, since a
bin of dead rows loses to any other element and, selected, decodes to a dead
entry either way.

The TPU's order among tied values inside a bin and its lane layout cannot
be observed off the TPU, so the binning above is the port's own definition;
:func:`partial_reduce_plain` states it in plain torch.

Where it runs: :func:`approx_rank_topk` reduces on a CUDA tensor with the
kernel and takes the exact top-k of the bins with ``torch.topk`` (the
aggregate sort of XLA's lowering).  On a CPU tensor it returns the exact
top-k, as the JAX package does on the CPU.  :func:`partial_reduce` runs its
plain twin only for a tensor on the CPU; on a CUDA tensor it launches the
kernel or raises.

The scan paths hand over the raw int32 bit products and let the kernel form
the rank value ``popc - 2 * dot`` (``_DEAD`` at masked rows) as it reads
them, so the ``[Q, N]`` int64 key of the exact path is never written.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .._build import cuda_library

# dead-entry sentinel for the rank key: far above any real rank value
# (|part| <= B <= a few thousand) and exact in float32; the JAX package's
# value
_DEAD = 1 << 30
INT64_MAX = 2 ** 63 - 1
MAX_Q = 65535              # rows per launch (the grid's y extent)
RECALL_TARGET = 0.98       # the JAX package's recall_target everywhere
_TILING = 128              # XLA's TPU lane tiling for a rank-2 operand
_LOW32 = 0xFFFFFFFF

_LIB: ctypes.CDLL | None = None


def reduction_output_size(n: int, k: int,
                          recall_target: float = RECALL_TARGET
                          ) -> tuple[int, int]:
    """``(W, r)``: the bins and the log2 reduction of XLA's
    ``ApproxTopKReductionOutputSize`` for a rank-2 operand reduced along a
    row of ``n`` elements (no input-size override).  ``r == 0`` means no
    reduction: the result is the exact top-k and ``W == n``."""
    if n <= _TILING:
        return n, 0
    # XLA takes the target as a float and the log in double
    target = float(np.float32(recall_target))
    if target == 1.0:
        return n, 0
    if not 0.0 < target < 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got "
                         f"{recall_target}")
    if not 0 < k <= n:
        raise ValueError(f"k must lie in [1, {n}], got {k}")
    if k == 1:
        # the least element survives any binning, and XLA reduces the row
        # to one 128-lane tile: r = log2_ceil(ceil(n / 128)) (read from
        # its results; tests/test_torch_approx_topk.py holds the grid)
        r = (-(-n // _TILING) - 1).bit_length()
    else:
        m = min(max(int((1.0 - k) / math.log(target)), _TILING), n)
        r = (n // m).bit_length() - 1
    if r == 0:
        return n, 0
    per_bin = -(-n // (1 << r))
    return _TILING * -(-per_bin // _TILING), r


def _rank_keys(part: torch.Tensor, row0: int = 0, popc=None, scale: int = 1,
               dead=None) -> torch.Tensor:
    """int64 [Q, C] keys ``(value << 32) | (row0 + column)`` of the rank
    value ``scale * part + popc`` (``_DEAD`` where ``dead``); ``part`` is
    not modified."""
    key = part.to(torch.int64)
    if scale != 1:
        key.mul_(scale)
    if popc is not None:
        key.add_(popc)
    if dead is not None:
        key.masked_fill_(dead[None, :], _DEAD)
    key <<= 32
    key |= torch.arange(row0, row0 + part.shape[1], dtype=torch.int64,
                        device=part.device)
    return key


def _smallest(key: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` least keys of each row, ascending, decoded to (value,
    row) int32 pairs; the INT64_MAX of an empty bin decodes to a dead
    entry, ``(_DEAD, -1)``."""
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return (key >> 32).clamp_(max=_DEAD).to(torch.int32), \
        (key & _LOW32).to(torch.int32)


def _rank_topk(part: torch.Tensor, k: int, row0: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest ``(part, row)`` pairs of each row of ``part``
    (int32 [Q, C]; row ids ``row0 + column``), ascending — the order of
    ``lax.top_k(-part)``, which keeps the lower index first on ties.
    Returns (part int32 [Q, k], row int32 [Q, k])."""
    return _smallest(_rank_keys(part, row0), k)


def partial_reduce_plain(part: torch.Tensor, w: int, r: int, row0: int = 0,
                         popc=None, scale: int = 1, dead=None, off: int = 0
                         ) -> torch.Tensor:
    """The plain torch version of the kernel: int64 [Q, W] bin minima of
    the keys of :func:`_rank_keys`, element ``i`` in bin ``(i + off) mod
    W`` — the keys padded with INT64_MAX, ``off`` columns in front and up
    to ``W * 2^r`` behind, viewed as ``[Q, 2^r, W]`` and reduced over the
    middle axis."""
    q, c = part.shape
    key = _rank_keys(part, row0, popc, scale, dead)
    span = w << r
    if off < 0 or span < c + off:
        raise ValueError(f"{1 << r} x {w} bins cannot hold {c} columns "
                         f"after {off}")
    key = torch.cat([key.new_full((q, off), INT64_MAX), key,
                     key.new_full((q, span - c - off), INT64_MAX)], dim=1)
    return key.view(q, 1 << r, w).amin(dim=1)


def _lib() -> ctypes.CDLL:
    """Build (first use), load and bind the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_library("approx_topk")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fspann_partial_reduce.argtypes = [vp, ci, ci, ci, ci, ci, vp, ci,
                                              vp, ctypes.c_longlong, vp, vp]
        lib.fspann_partial_reduce.restype = ci
        lib.fspann_cuda_error_string.argtypes = [ci]
        lib.fspann_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(part: torch.Tensor, popc, dead) -> None:
    if part.dim() != 2 or part.dtype != torch.int32:
        raise TypeError(f"expected int32 [Q, C], got {part.dtype} "
                        f"{tuple(part.shape)}")
    c = part.shape[1]
    for name, t, dtype in (("popc", popc, torch.int32),
                           ("dead", dead, torch.bool)):
        if t is None:
            continue
        if t.shape != (c,) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} [{c}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != part.device:
            raise ValueError(f"{name} on {t.device}, values on "
                             f"{part.device}")


def partial_reduce(part: torch.Tensor, w: int, r: int, row0: int = 0,
                   popc=None, scale: int = 1, dead=None, off: int = 0
                   ) -> torch.Tensor:
    """Bin minima int64 [Q, W] of the rank keys of ``part`` (int32 [Q, C]),
    element ``i`` in bin ``(i + off) mod W``, ``W * 2^r >= C + off``: the
    kernel on a CUDA tensor, :func:`partial_reduce_plain` on a CPU tensor.

    ``popc`` (int32 [C]) and ``scale`` make the rank value ``scale * part
    + popc``; ``dead`` (bool [C]) sets it to ``_DEAD``; row ids are ``row0
    + column``."""
    _check(part, popc, dead)
    if part.device.type == "cpu":
        return partial_reduce_plain(part, w, r, row0, popc, scale, dead, off)
    q, c = part.shape
    if not (part.is_contiguous()
            and (popc is None or popc.is_contiguous())
            and (dead is None or dead.is_contiguous())):
        raise ValueError("partial_reduce takes contiguous tensors")
    if not 0 < q <= MAX_Q or c < 1 or off < 0 or (w << r) < c + off \
            or not 0 <= row0 <= row0 + c <= 2 ** 31:
        raise ValueError(f"partial_reduce: unsupported Q={q}, C={c}, W={w}, "
                         f"r={r}, off={off}, row0={row0}")
    out = torch.empty((q, w), dtype=torch.int64, device=part.device)
    lib = _lib()
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        err = lib.fspann_partial_reduce(
            part.data_ptr(), q, c, w, 1 << r, off,
            None if popc is None else popc.data_ptr(), scale,
            None if dead is None else dead.data_ptr(), row0, out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"approx_topk partial_reduce launch failed: CUDA "
                           f"error {err} "
                           f"({lib.fspann_cuda_error_string(err).decode()})")
    partial_reduce.launches += 1
    if off:
        partial_reduce.tail_launches += 1
    return out


def binned_rank_topk(part: torch.Tensor, k: int, w: int, r: int,
                     row0: int = 0, popc=None, scale: int = 1, dead=None,
                     off: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce to ``w`` bins (:func:`partial_reduce`), then take the exact
    ``k`` least bin keys, ascending, as (value int32 [Q, k], row int32
    [Q, k]).  On a CPU tensor this is the plain statement of what the card
    computes."""
    return _smallest(partial_reduce(part, w, r, row0, popc, scale, dead, off),
                     k)


def approx_rank_topk(part: torch.Tensor, k: int, row0: int = 0,
                     recall_target: float = RECALL_TARGET, *, popc=None,
                     scale: int = 1, dead=None, width: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The approximate ``k`` smallest ``(value, row)`` pairs of each row,
    ascending, where value is ``scale * part + popc`` (``_DEAD`` where
    ``dead``) and row ``row0 + column``: ``lax.approx_max_k`` of the
    negated values.  Returns (value int32 [Q, k], row int32 [Q, k]).
    ``width`` (>= the row's ``C`` columns) is the block the row ends: its
    first ``width - C`` columns dead (the module docstring).

    On a CUDA tensor with ``r > 0`` this is :func:`binned_rank_topk` (the
    kernel, then ``torch.topk`` of the bins); otherwise (``r == 0``, or a
    CPU tensor, where the JAX package computes the exact top-k too) the
    exact top-k, :func:`_rank_topk`'s order.  So is a row of at most ``W``
    columns: each sits alone in its bin."""
    c = part.shape[1]
    width = c if width is None else width
    w, r = reduction_output_size(width, k, recall_target)
    if r > 0 and c > w and part.device.type != "cpu":
        return binned_rank_topk(part, k, w, r, row0, popc, scale, dead,
                                width - c)
    _check(part, popc, dead)
    return _smallest(_rank_keys(part, row0, popc, scale, dead), k)


# kernel launches since the last reset, and those of them with an offset (a
# chunked scan's tail); chip_smoke.py reads and resets both
partial_reduce.launches = 0
partial_reduce.tail_launches = 0
