"""Bit products of packed codes: the hand-written tensor-core kernel
(``csrc/packed_dots.cu``) and its plain torch version.

The packed chunked scan (``ops/hamming_scan.scan_chunks`` over a
``PackedScanState``) scores each chunk of int32 code words against the
query bits: ``dots[q, c] = sum_b qbits[q, b] * bit(words[c], b)``.  The JAX
package unpacks the chunk into an int8 bit block and takes an int8 dot
(``fspann_tpu/ops/hamming_scan.py`` ``scan_chunk_merge``); so does
:func:`packed_dots_plain`.  The kernel reads the words once and expands
them into the tensor cores' operands in registers, so no chunk-sized block
of bits is ever written to device memory (the kernel's source note says
how, and what bounds it).

Where it runs: :func:`packed_dots` runs the plain version only for a tensor
on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import cuda_library

QT = 64                  # queries a block tile (csrc/packed_dots.cu)
MAX_Q = 65535 * QT       # the grid's y extent, in query tiles
MAX_ROWS = 2 ** 31 - 1

_LIB: ctypes.CDLL | None = None


def packed_dots_plain(qbits: torch.Tensor, words: torch.Tensor,
                      code_bits: int) -> torch.Tensor:
    """The plain torch version: the words unpacked to an int8 bit block
    (``unpack_bits_device``), then the exact int8 product (``_bit_dots``)."""
    # imported here: ops/hamming_scan imports this module
    from .hamming_scan import _bit_dots, unpack_bits_device
    return _bit_dots(qbits, unpack_bits_device(words, code_bits))


def _lib() -> ctypes.CDLL:
    """Build (first use), load and bind the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_library("packed_dots")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fspann_packed_dots.argtypes = [vp, ci, ci, ci, ci, vp,
                                           ctypes.c_longlong, vp, vp, vp]
        lib.fspann_packed_dots.restype = ci
        lib.fspann_cuda_error_string.argtypes = [ci]
        lib.fspann_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(qbits: torch.Tensor, words: torch.Tensor, code_bits: int) -> None:
    if words.dim() != 3 or words.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"expected int32 (or int64-held) words [C, G, W], "
                        f"got {words.dtype} {tuple(words.shape)}")
    _c, g, w = words.shape
    if qbits.dim() != 2 or qbits.dtype != torch.int8:
        raise TypeError(f"expected int8 query bits [Q, B], got {qbits.dtype} "
                        f"{tuple(qbits.shape)}")
    if not 0 < code_bits <= 32 * w or qbits.shape[1] != g * code_bits:
        raise ValueError(f"query bits [{qbits.shape[1]}] do not match {g} "
                         f"groups of {code_bits} bits in {w} words")
    if qbits.device != words.device:
        raise ValueError(f"query bits on {qbits.device}, words on "
                         f"{words.device}")


def packed_dots(qbits: torch.Tensor, words: torch.Tensor, code_bits: int
                ) -> torch.Tensor:
    """int32 [Q, C] bit products of the query bits (int8 0/1 [Q, G *
    code_bits], MSB first) and the packed words (int32 bit patterns [C, G,
    W], or int64 holding them): the kernel on a CUDA tensor,
    :func:`packed_dots_plain` on a CPU tensor.  Equal, integer for integer,
    to ``_bit_dots(qbits, unpack_bits_device(words, code_bits))``."""
    _check(qbits, words, code_bits)
    if words.device.type == "cpu":
        return packed_dots_plain(qbits, words, code_bits)
    if words.dtype != torch.int32:
        words = words.to(torch.int32)    # the low 32 bits, as the unpack
    if not (words.is_contiguous() and qbits.is_contiguous()):
        raise ValueError("packed_dots takes contiguous tensors")
    q, c = qbits.shape[0], words.shape[0]
    _c, g, w = words.shape
    out = torch.empty((q, c), dtype=torch.int32, device=words.device)
    if q == 0 or c == 0:
        return out
    if q > MAX_Q or c > MAX_ROWS:
        raise ValueError(f"packed_dots: unsupported Q={q}, C={c}")
    qwords = torch.empty((q, g * w), dtype=torch.int32, device=words.device)
    lib = _lib()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.fspann_packed_dots(qbits.data_ptr(), q, g, w, code_bits,
                                     words.data_ptr(), c, qwords.data_ptr(),
                                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"packed_dots launch failed: CUDA error {err} "
                           f"({lib.fspann_cuda_error_string(err).decode()})")
    packed_dots.launches += 1
    return out


# kernel launches since the last reset; tests and chip_smoke.py read them
packed_dots.launches = 0
