"""Full-code Hamming of routed candidates: the hand-written CUDA kernel's
wrapper and its plain torch twin.

The probe route re-scores every routed candidate by the Hamming distance
between the query's and the candidate's own packed codes over all groups
(``fspann_tpu/ops/routing.py:281-283`` in ``route_rerank``, ``:334-336`` in
``rerank``).  The JAX package leaves the gather + XOR + popcount to XLA.
PyTorch has no popcount, and the plain version materialises the gathered
codes [Q, R, C] and int64 bit-count scratch of the same shape, so on CUDA
this is a kernel: ``csrc/code_hamming.cu`` (built for sm_90a at first use),
one warp per candidate row, the query's words in shared memory.

On a CPU tensor :func:`code_hamming` runs :func:`code_hamming_plain` — that
is the only reason it ever does.  On a CUDA tensor it launches the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import cuda_library
from .hamming import hamming

MAX_C = 192     # words per point: the 6,144-bit codes of the 960-d config
MAX_Q = 65535   # queries per launch (the kernel's grid.y)
_INF = 2 ** 31 - 1
# gathered words per chunk of the plain version (its scratch is a few
# times this many int64 values)
_PLAIN_CHUNK = 1 << 24

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """Build (first use), load and bind the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_library("code_hamming")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fspann_code_hamming.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp,
                                            vp]
        lib.fspann_code_hamming.restype = ci
        lib.fspann_cuda_error_string.argtypes = [ci]
        lib.fspann_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def code_hamming_plain(point_codes: torch.Tensor, qcodes: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """The plain torch version: gather, XOR, SWAR popcount, chunked over
    queries so that its scratch stays bounded."""
    n, c = point_codes.shape
    q, r = ids.shape
    out = torch.empty((q, r), dtype=torch.int32, device=ids.device)
    rows = max(1, _PLAIN_CHUNK // max(1, r * c))
    for lo in range(0, q, rows):
        sid = ids[lo:lo + rows]
        ok = (sid >= 0) & (sid < n)
        safe = torch.where(ok, sid, torch.zeros_like(sid)).to(torch.int64)
        fine = hamming(point_codes[safe], qcodes[lo:lo + rows, None, :])
        out[lo:lo + rows] = torch.where(ok, fine, torch.full_like(fine, _INF))
    return out


def code_hamming(point_codes: torch.Tensor, qcodes: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Hamming distance from each query's code to each candidate's code.

    Args:
      point_codes: int32 [N, C] packed code bit patterns of every row
        (C = G·W words), contiguous.
      qcodes: int32 [Q, C] the queries' packed codes, same device.
      ids: int32 [Q, R] candidate rows per query; any id outside [0, N)
        is a pad.

    Returns int32 [Q, R]: ``Σ_w popc(point_codes[ids[q, r], w] ^ qcodes[q,
    w])``, and INT32_MAX at pads.
    """
    if point_codes.dim() != 2 or qcodes.dim() != 2 or ids.dim() != 2 \
            or qcodes.shape[1] != point_codes.shape[1] \
            or ids.shape[0] != qcodes.shape[0]:
        raise ValueError(f"expected point_codes [N, C], qcodes [Q, C] and "
                         f"ids [Q, R], got {tuple(point_codes.shape)}, "
                         f"{tuple(qcodes.shape)} and {tuple(ids.shape)}")
    if not (point_codes.dtype == qcodes.dtype == ids.dtype == torch.int32):
        raise TypeError("code_hamming takes int32 tensors")
    if not (point_codes.device == qcodes.device == ids.device):
        raise ValueError(f"tensors on {point_codes.device}, {qcodes.device} "
                         f"and {ids.device}")
    n, c = point_codes.shape
    q, r = ids.shape
    if c > MAX_C:
        raise ValueError(f"code_hamming supports C <= {MAX_C} words, got {c}")
    dev = ids.device
    if dev.type == "cpu":
        return code_hamming_plain(point_codes, qcodes, ids)
    if dev.type != "cuda":
        raise ValueError(f"code_hamming runs on cuda or cpu, not {dev}")
    if not (point_codes.is_contiguous() and qcodes.is_contiguous()
            and ids.is_contiguous()):
        raise ValueError("code_hamming takes contiguous tensors")
    if q > MAX_Q:
        raise ValueError(f"code_hamming supports Q <= {MAX_Q}, got {q}")
    out = torch.empty((q, r), dtype=torch.int32, device=dev)
    if q == 0 or r == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fspann_code_hamming(point_codes.data_ptr(), n, c,
                                      qcodes.data_ptr(), q, ids.data_ptr(),
                                      r, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"code_hamming launch failed: CUDA error {err} "
                           f"({lib.fspann_cuda_error_string(err).decode()})")
    code_hamming.launches += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads and resets it)
code_hamming.launches = 0
