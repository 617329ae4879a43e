"""Peaks of the card and the least time of each measured kernel's work.

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W power
limit (dense rates).  Each bound counts the work the algorithm needs for
the call's shapes, whatever implements it: every input byte read once and
every output byte written once, or the operations at the matching peak,
whichever takes longer.  ``topk_bound_ms``, ``approx_bound_ms`` and
``hamming_bound`` are the arithmetic the port's bring-up smoke used for its
kernel tables, kept here so that the yardstick cannot move with the
program.
"""

from __future__ import annotations

F32_FLOPS = 67e12       # float32 on the CUDA cores
INT8_OPS = 1979e12      # int8 on the tensor cores
HBM_BYTES = 3.35e12     # HBM3 bytes per second


def _bound(ops_s: float, mem_s: float) -> tuple[float, str]:
    return max(ops_s, mem_s), "operations" if ops_s >= mem_s else "bytes"


def topk_bound_ms(n: int, d: int, nq: int, k: int) -> tuple[float, str]:
    """Exact L2 top-k of ``nq`` queries over ``n`` rows of ``d`` float32:
    2 Q N d FLOP at the float32 peak against the rows and queries read once
    and the int32 ids and float32 distances written once."""
    ops = 2 * nq * n * d / F32_FLOPS
    mem = (4 * (n * d + nq * d) + 8 * nq * k) / HBM_BYTES
    s, by = _bound(ops, mem)
    return s * 1e3, by


def approx_bound_ms(q: int, c: int, w: int) -> tuple[float, str]:
    """The approximate top-L's partial reduce over [q, c] int32 products
    into ``w`` bins: the products, the int32 popcounts and the one-byte dead
    marks read once and the int64 bins written once, against one compare an
    element at the float32 peak."""
    mem = (4 * q * c + 5 * c + 8 * q * w) / HBM_BYTES
    ops = q * c / F32_FLOPS
    s, by = _bound(ops, mem)
    return s * 1e3, by


def hamming_bound(distinct_rows: int, words: int, qcode_words: int,
                  id_slots: int) -> tuple[int, float]:
    """(bytes, least milliseconds) of one ``code_hamming`` launch: each
    distinct candidate row of ``words`` int32 read once, the query codes
    and the ids read, the int32 scores written."""
    nbytes = distinct_rows * words * 4 + qcode_words * 4 + 2 * id_slots * 4
    return nbytes, nbytes / HBM_BYTES * 1e3


def scan_bound_s(q: int, n: int, bits: int, limit: int) -> tuple[float, str]:
    """Stage A of the scan route for ``q`` queries over ``n`` live rows of
    ``bits``-bit codes, keeping ``limit`` ids a query: the bit products,
    2 Q N B int8 operations, against the codes read once at their packed
    size (N B / 8 bytes), the query bits read and the int32 ids written.
    The same work whatever layout or selection implements it."""
    ops = 2 * q * n * bits / INT8_OPS
    mem = (n * bits // 8 + q * bits + 4 * q * limit) / HBM_BYTES
    return _bound(ops, mem)
