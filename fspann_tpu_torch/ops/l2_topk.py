"""Exact L2 top-k over a whole base: the hand-written CUDA kernel's wrapper.

Port of ``fspann_tpu/ops/pallas_topk.py`` (``bitonic_topk`` → the Pallas
TPU kernel ``_topk_kernel``).  The kernel (``csrc/l2_topk.cu``, built for
sm_90a at first use) streams the base once per query tile of 64 through a
cp.async ring, computes the scores on the tensor cores in split TF32
(float32-accurate), keeps a running top-K per (query, base split) in global
scratch and merges the splits in a second pass; see the note at the top of
the source.  The launch geometry (:func:`_splits`) lives here, where the
CPU tests reach it.  Its plain twin is
:func:`fspann_tpu_torch.ops.refine.bruteforce_topk`.

On a CPU tensor :func:`l2_topk` runs the plain twin — that is the only
reason it ever does.  On a CUDA tensor it launches the kernel or raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction

import torch

from .._build import cuda_library
from . import refine

MAX_K = 128    # the kernel's running-list width (csrc/l2_topk.cu KP);
               # the kernel refuses a larger k with cudaErrorInvalidValue
MAX_D = 960    # widest vectors of the repository's configurations
# csrc/l2_topk.cu: queries per block (QT) and pass 1's resident blocks per
# SM (104 KB, 106,240 B, of shared memory each); chip_smoke.py checks the
# latter on the card (``blocks_per_sm``)
QT = 64
RESIDENT = 2
SORT = 512          # scratch pairs per (query, split): list + buffer
MIN_ROWS = 1024     # fewest base rows a split is given (8 row tiles)
MAX_WAVES = 4       # most waves that extra splits may cost
# Most ``float64_error`` a float32-accurate top-k may show: about the
# geometric mean of the split-TF32 kernel's largest reading on the H100
# (1.7e-6) and the smallest of the same kernel with one TF32 pass (3.5e-5),
# from scripts/torch_l2_topk_precision.py (PERF.md)
F32_ERROR_LIMIT = 7.5e-6

_LIB: ctypes.CDLL | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``csrc/l2_topk.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fspann_l2_topk.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci,
                                   vp, vp, vp, vp, vp, vp]
    lib.fspann_l2_topk.restype = ci
    lib.fspann_l2_topk_blocks_per_sm.argtypes = []
    lib.fspann_l2_topk_blocks_per_sm.restype = ci
    lib.fspann_cuda_error_string.argtypes = [ci]
    lib.fspann_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    """Build (first use), load and bind the kernel library."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(cuda_library("l2_topk"))
    return _LIB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _splits(n: int, nq: int, sms: int) -> tuple[int, int]:
    """Base splits for pass 1, for a card of ``sms`` SMs.  Returns
    ``(rows_per_split, splits)``; every split holds at least one row.

    The grid is (query tiles x splits) blocks, ``RESIDENT`` of them on an SM
    at once.  Of the split counts that leave each split ``MIN_ROWS`` rows
    and cost at most ``MAX_WAVES`` waves, the one whose last wave is fullest
    is taken (the fewest on a tie): whole waves where query tiles x splits
    can be a multiple of ``sms * RESIDENT``, and all the splits there are
    where the whole grid fits in one wave."""
    slots = sms * RESIDENT
    qt = _cdiv(nq, QT)
    cap = max(1, min(n // MIN_ROWS, MAX_WAVES * slots // qt))
    splits = max(range(1, cap + 1), key=lambda s: (
        Fraction(qt * s, _cdiv(qt * s, slots) * slots), -s))
    rows = _cdiv(n, splits)
    return rows, _cdiv(n, rows)


def float64_error(base: torch.Tensor, queries: torch.Tensor,
                  ids: torch.Tensor, dists: torch.Tensor) -> float:
    """Error of a top-k's distances against float64, in units of the sums
    they come from: the largest ``|dist² − d64²| / (|q|² + |b|²)`` over the
    returned (query, row) pairs, with ``d64`` the pair's float64 distance.
    Free of the data's scale, so one limit (``F32_ERROR_LIMIT``) serves
    every shape."""
    b = base[ids.long()].double()
    q = queries.double()[:, None, :]
    d64 = ((b - q) ** 2).sum(dim=-1)
    scale = torch.clamp((b * b).sum(dim=-1) + (q * q).sum(dim=-1),
                        min=torch.finfo(torch.float32).tiny)
    return float(((dists.double() ** 2 - d64).abs() / scale).max())


def blocks_per_sm() -> int:
    """Pass 1's resident blocks per SM on the current card, as the CUDA
    occupancy calculator gives it (``RESIDENT`` is what ``_splits``
    assumes)."""
    got = _lib().fspann_l2_topk_blocks_per_sm()
    if got < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-got}")
    return got


def l2_topk(base: torch.Tensor, queries: torch.Tensor, k: int = 100
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-``k`` of ``queries`` over ``base``.

    Args:
      base: f32 [N, d], contiguous.
      queries: f32 [Q, d], contiguous, on the same device.
      k: 1 <= k <= 128 (clamped to N, as ``bitonic_topk`` does).

    Returns ``(ids int32 [Q, k], dists f32 [Q, k])`` — true L2 distances in
    ascending ``(|b|² − 2q·b, id)`` order, ids distinct — the contract of
    ``fspann_tpu.ops.pallas_topk.bitonic_topk``.
    """
    if base.dim() != 2 or queries.dim() != 2 \
            or base.shape[1] != queries.shape[1]:
        raise ValueError(f"expected base [N, d] and queries [Q, d], got "
                         f"{tuple(base.shape)} and {tuple(queries.shape)}")
    if base.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("l2_topk takes float32 tensors")
    if base.device != queries.device:
        raise ValueError(f"base on {base.device}, queries on "
                         f"{queries.device}")
    n, d = base.shape
    nq = queries.shape[0]
    k = min(k, n)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"l2_topk supports 1 <= k <= {MAX_K}, got {k}")
    if d > MAX_D:
        raise ValueError(f"l2_topk supports d <= {MAX_D}, got {d}")
    if base.device.type == "cpu":
        return refine.bruteforce_topk(base, queries, k)
    if base.device.type != "cuda":
        raise ValueError(f"l2_topk runs on cuda or cpu, not {base.device}")
    if not (base.is_contiguous() and queries.is_contiguous()):
        raise ValueError("l2_topk takes contiguous tensors")
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.int32, device=base.device),
                torch.empty((0, k), dtype=torch.float32, device=base.device))
    lib = _lib()
    dev = base.device
    rows, splits = _splits(
        n, nq, torch.cuda.get_device_properties(dev).multi_processor_count)
    scr_v = torch.empty((nq, splits, SORT), dtype=torch.float32, device=dev)
    scr_i = torch.empty((nq, splits, SORT), dtype=torch.int32, device=dev)
    # each query's published threshold, as int32 in float order: +inf
    thr = torch.full((nq,), float("inf"), dtype=torch.float32, device=dev)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fspann_l2_topk(base.data_ptr(), queries.data_ptr(), n, d,
                                 nq, k, rows, splits, scr_v.data_ptr(),
                                 scr_i.data_ptr(), thr.data_ptr(),
                                 out_v.data_ptr(),
                                 out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"l2_topk launch failed: CUDA error {err} "
                           f"({lib.fspann_cuda_error_string(err).decode()})")
    l2_topk.launches += 1
    qsq = (queries * queries).sum(dim=1)
    return out_i, torch.sqrt(torch.clamp(out_v + qsq[:, None], min=0.0))


# kernel launches since the last reset (chip_smoke.py reads and resets it)
l2_topk.launches = 0
