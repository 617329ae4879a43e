"""Exact L2 top-k over a whole base: the hand-written CUDA kernel's wrapper.

Port of ``fspann_tpu/ops/pallas_topk.py`` (``bitonic_topk`` → the Pallas
TPU kernel ``_topk_kernel``).  The kernel (``csrc/l2_topk.cu``, built for
sm_90a at first use) streams the base once per query tile, keeps a running
top-K per query in shared memory and merges base splits in a second pass;
see the note at the top of the source.  Its plain twin is
:func:`fspann_tpu_torch.ops.refine.bruteforce_topk`.

On a CPU tensor :func:`l2_topk` runs the plain twin — that is the only
reason it ever does.  On a CUDA tensor it launches the kernel or raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import cuda_library
from . import refine

MAX_K = 128    # the kernel's running-list width (csrc/l2_topk.cu KP);
               # the kernel refuses a larger k with cudaErrorInvalidValue
MAX_D = 960    # widest vectors of the repository's configurations
# query and row tile of csrc/l2_topk.cu (QT, TN): sizing the base splits
# only, any split length is correct
_QT = 32
_TN = 128

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """Build (first use), load and bind the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_library("l2_topk")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fspann_l2_topk.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci,
                                       vp, vp, vp, vp, vp]
        lib.fspann_l2_topk.restype = ci
        lib.fspann_cuda_error_string.argtypes = [ci]
        lib.fspann_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _splits(n: int, nq: int, device: torch.device) -> tuple[int, int]:
    """Base splits for pass 1: about two blocks per SM across the query
    tiles, at least 8 row tiles per split.  Returns (rows_per_split,
    splits)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(_cdiv(2 * sms, _cdiv(nq, _QT)), _cdiv(n, 8 * _TN)))
    rows = _cdiv(_cdiv(n, splits), _TN) * _TN
    return rows, _cdiv(n, rows)


def l2_topk(base: torch.Tensor, queries: torch.Tensor, k: int
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
    rows, splits = _splits(n, nq, dev)
    part_v = torch.empty((nq, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fspann_l2_topk(base.data_ptr(), queries.data_ptr(), n, d,
                                 nq, k, rows, splits, part_v.data_ptr(),
                                 part_i.data_ptr(), out_v.data_ptr(),
                                 out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"l2_topk launch failed: CUDA error {err} "
                           f"({lib.fspann_cuda_error_string(err).decode()})")
    l2_topk.launches += 1
    qsq = (queries * queries).sum(dim=1)
    return out_i, torch.sqrt(torch.clamp(out_v + qsq[:, None], min=0.0))


# kernel launches since the last reset (chip_smoke.py reads and resets it)
l2_topk.launches = 0
