"""Full-code Hamming of routed candidates: the hand-written CUDA kernel's
wrapper and its plain torch twin.

The probe route re-scores every routed candidate by the Hamming distance
between the query's and the candidate's own packed codes over all groups
(``fspann_tpu/ops/routing.py:281-283`` in ``route_rerank``, ``:334-336`` in
``rerank``).  The JAX package leaves the gather + XOR + popcount to XLA.
PyTorch has no popcount, and the plain version materialises the gathered
codes [Q, R, C] and int64 bit-count scratch of the same shape, so on CUDA
this is a kernel: ``csrc/code_hamming.cu`` (built for sm_90a at first use),
with two paths.  The gather path fetches each candidate's row on its own,
one warp a row.  The sweep path brings the code array through shared memory
in windows of consecutive rows and scores, window by window, the candidates
whose row lies in it, so a row that many queries name leaves device memory
once per batch.  :func:`choose_path` picks between them from the sizes.
The sweep finds a window's candidates by a span rule: a pre-pass records,
for each (window, query), the first and last column whose id lies in the
window, and the sweep scores the columns of that span whose id does.

On a CPU tensor :func:`code_hamming` runs :func:`code_hamming_plain` — that
is the only reason it ever does.  On a CUDA tensor it launches the kernel or
raises; nothing falls back.  Each call counts its candidate slots
(``code_hamming.slots``) and those scored by a gather, the kernel's or the
plain version's (``code_hamming.gather_slots``), under the open request.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import cuda_library
from ..utils.profiler import count
from .hamming import hamming

MAX_C = 192     # words per point: the 6,144-bit codes of the 960-d config
MAX_Q = 65535   # queries per launch
_INF = 2 ** 31 - 1
# gathered words per chunk of the plain version (its scratch is a few
# times this many int64 values)
_PLAIN_CHUNK = 1 << 24

# The sweep's geometry: one block of SWEEP_THREADS threads to an SM, whose
# shared memory (SWEEP_SMEM_BYTES of Hopper's 227 KB) holds the queries'
# codes, three windows of rows and the windows' spans, ids and item lists
# (sweep_smem_bytes mirrors csrc/code_hamming.cu's sweep_words).  A window is
# the largest power of two of rows that fits: 128 rows at 96 words and 64
# queries, 64 rows at 192 words.
SWEEP_SMEM_BYTES = 220 * 1024
MAX_WINDOW_SHIFT = 10   # an item holds its row of the window in 10 bits
SWEEP_THREADS = 1024
SWEEP_MAX_Q = 1024      # the kernel's MAX_SWEEP_Q
_ID_CAP = 16
# Where the sweep pays, placed on an H100 80GB HBM3 at 700 W (scripts/
# torch_code_hamming_bench.py, 1M rows, R = 49,152): it reads all N rows
# whatever Q is, the gather Q x R rows at most.  At 96 words and Q = 16 (0.8
# slots a row) the gather took 0.116 ms and the sweep 0.150; at Q = 32 (1.6)
# 0.210 and 0.171; at Q = 64 (3.1) 0.384 and 0.238.  At 192 words (64-row
# windows) Q = 16 0.177 and 0.274, Q = 32 0.309 and 0.309, Q = 64 0.544 and
# 0.411.  Windows under 64 rows were not measured and are not picked.
SWEEP_MIN_SLOTS_PER_ROW = 1.5
SWEEP_MIN_WINDOW_SHIFT = 6

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """Build (first use), load and bind the kernel library."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(cuda_library("code_hamming"))
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fspann_code_hamming.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp, vp]
    lib.fspann_code_hamming.restype = ci
    lib.fspann_code_hamming_sweep.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp,
                                              vp, ci, ci, vp]
    lib.fspann_code_hamming_sweep.restype = ci
    lib.fspann_cuda_error_string.argtypes = [ci]
    lib.fspann_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _round4(words: int) -> int:
    return (words + 3) & ~3


def sweep_smem_bytes(c: int, shift: int, q: int) -> int:
    """Dynamic shared memory of the sweep kernel at 2^``shift`` rows a
    window."""
    return 4 * (_round4(c * q) + 3 * _round4(c << shift)
                + 5 * _round4(2 * q) + 3 * (_ID_CAP + 4) * q
                + 2 * _ID_CAP * q)


def window_shift(c: int, q: int) -> int:
    """log2 of the sweep's rows per window at ``c`` words per row and ``q``
    queries, or -1 where not even one row fits."""
    shift = -1
    while shift < MAX_WINDOW_SHIFT \
            and sweep_smem_bytes(c, shift + 1, q) <= SWEEP_SMEM_BYTES:
        shift += 1
    return shift


def choose_path(q: int, r: int, n: int, c: int, ascending: bool) -> str:
    """``"sweep"`` or ``"gather"`` for a batch of ``q`` x ``r`` candidate
    slots over ``n`` rows of ``c`` words.  ``ascending`` is the caller's
    word that live ids rise with the column: without it a query's span in a
    window may cover all its columns, so the sweep is never picked.  Nor is
    it where shared memory has no room for windows of
    2^SWEEP_MIN_WINDOW_SHIFT rows beside the queries' codes."""
    if ascending and q <= SWEEP_MAX_Q \
            and q * r >= SWEEP_MIN_SLOTS_PER_ROW * n \
            and window_shift(c, q) >= SWEEP_MIN_WINDOW_SHIFT:
        return "sweep"
    return "gather"


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


def _check(point_codes: torch.Tensor, qcodes: torch.Tensor,
           ids: torch.Tensor) -> None:
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
    if point_codes.shape[1] > MAX_C:
        raise ValueError(f"code_hamming supports C <= {MAX_C} words, got "
                         f"{point_codes.shape[1]}")


def _launch(path: str, point_codes: torch.Tensor, qcodes: torch.Tensor,
            ids: torch.Tensor, shift: int | None = None,
            threads: int = SWEEP_THREADS) -> torch.Tensor:
    """One launch of the kernel's ``path`` on CUDA tensors."""
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"the code_hamming kernel runs on cuda, not {dev}")
    if not (point_codes.is_contiguous() and qcodes.is_contiguous()
            and ids.is_contiguous()):
        raise ValueError("code_hamming takes contiguous tensors")
    n, c = point_codes.shape
    q, r = ids.shape
    if q > MAX_Q:
        raise ValueError(f"code_hamming supports Q <= {MAX_Q}, got {q}")
    out = torch.empty((q, r), dtype=torch.int32, device=dev)
    if q == 0 or r == 0:
        return out
    lib = _lib()
    args = (point_codes.data_ptr(), n, c, qcodes.data_ptr(), q,
            ids.data_ptr(), r, out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "sweep":
            if shift is None:
                shift = window_shift(c, q)
            if shift < 0:
                raise ValueError(f"the sweep's shared memory cannot hold {q} "
                                 f"queries of {c} words")
            windows = -(-n // (1 << shift))
            # span table [windows, Q, 2] and touched marks [windows]; the
            # call itself resets them, on this stream
            scratch = torch.empty(windows * (2 * q + 1), dtype=torch.int32,
                                  device=dev)
            err = lib.fspann_code_hamming_sweep(*args, scratch.data_ptr(),
                                                shift, threads, stream)
        else:
            err = lib.fspann_code_hamming(*args, stream)
    if err != 0:
        raise RuntimeError(f"code_hamming {path} launch failed: CUDA error "
                           f"{err} "
                           f"({lib.fspann_cuda_error_string(err).decode()})")
    code_hamming.launches += 1
    return out


def code_hamming(point_codes: torch.Tensor, qcodes: torch.Tensor,
                 ids: torch.Tensor, ascending: bool = False) -> torch.Tensor:
    """Hamming distance from each query's code to each candidate's code.

    Args:
      point_codes: int32 [N, C] packed code bit patterns of every row
        (C = G·W words), contiguous.
      qcodes: int32 [Q, C] the queries' packed codes, same device.
      ids: int32 [Q, R] candidate rows per query; any id outside [0, N)
        is a pad.
      ascending: the caller's word that each query's live ids rise with the
        column.  It touches speed only (:func:`choose_path`): the result is
        exact for ids in any order, whatever is promised.

    Returns int32 [Q, R]: ``Σ_w popc(point_codes[ids[q, r], w] ^ qcodes[q,
    w])``, and INT32_MAX at pads.
    """
    _check(point_codes, qcodes, ids)
    (n, c), (q, r) = point_codes.shape, ids.shape
    cpu = ids.device.type == "cpu"
    path = "gather" if cpu else choose_path(q, r, n, c, ascending)
    count("code_hamming.slots", q * r)
    if path == "gather":
        count("code_hamming.gather_slots", q * r)
    if cpu:
        return code_hamming_plain(point_codes, qcodes, ids)
    return _launch(path, point_codes, qcodes, ids)


def code_hamming_gather(point_codes: torch.Tensor, qcodes: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """:func:`code_hamming` by the kernel's gather path (CUDA tensors)."""
    _check(point_codes, qcodes, ids)
    return _launch("gather", point_codes, qcodes, ids)


def code_hamming_sweep(point_codes: torch.Tensor, qcodes: torch.Tensor,
                       ids: torch.Tensor, shift: int | None = None,
                       threads: int = SWEEP_THREADS) -> torch.Tensor:
    """:func:`code_hamming` by the kernel's sweep path (CUDA tensors), with
    2^``shift`` rows a window (default :func:`window_shift`)."""
    _check(point_codes, qcodes, ids)
    return _launch("sweep", point_codes, qcodes, ids, shift, threads)


# kernel launches since the last reset (chip_smoke.py reads and resets it);
# one per call, whichever path: the sweep's pre-pass is part of its launch
code_hamming.launches = 0
