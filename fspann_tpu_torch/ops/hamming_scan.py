"""Hamming scan: full-corpus fine-score ranking as an int8 bit matmul.

    Hamming(q, c) = popcount(q) + popcount(c) - 2 * <bits(q), bits(c)>

so ranking by Hamming is ranking by ``popc[c] - 2 * dot`` — one
``[Q, B] x [B, N]`` int8→int32 product (B = G·m·λ total code bits) plus a
top-L.  This replaces the reference's whole stage-A machinery (probe queue
over partitions, PartitionedIndexService.java:592-715) with an exact global
fine ranking.  Device memory: N·B int8 bytes (3.07 GB at 1M × 3,072 bits),
or, with the packed state (:class:`PackedScanState`), 4 bytes per 32 code
bits (0.38 GB at the same size), scored straight from the words
(``ops/packed_dots``).

The product is ``torch._int_mm`` (exact int8 → int32).  Its CUDA path wants
more than 16 rows in the first operand and widths that are multiples of 8,
so :func:`_bit_dots` pads short query batches and scores a ragged tail of
fewer than 8 corpus rows with an exact float32 product.

Order contract (must match ``fspann_tpu.ops.hamming_scan`` bit for bit):
ascending ``(score, id)``.  ``torch.topk`` does not keep the lower index
first on ties, so ranking runs on ONE int64 key ``(part << 32) | id``, which
is unique per row and orders exactly like the pair.

Routing–ciphertext orthogonality is unchanged: the scan state is a pure
function of the LSH codes the server already stores.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiler import count, span
from .approx_topk import _DEAD, _rank_topk, approx_rank_topk
from .coding import words_to_torch
from .packed_dots import packed_dots
from .routing import _INF, RouteResult

# byte -> popcount
_POPC8 = torch.tensor(np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                                    axis=1).sum(axis=1), dtype=torch.int32)


class ScanState(NamedTuple):
    bits: torch.Tensor   # int8 [N, B] unpacked 0/1 code bits (MSB-first order)
    popc: torch.Tensor   # int32 [N] popcount per point


class PackedScanState(NamedTuple):
    """Scan state kept PACKED on the device: 8× fewer resident bytes than
    the int8 bit matrix, so a card holds 8× more rows.  :func:`scan_chunked`
    scores one chunk at a time straight from its words
    (``ops/packed_dots``: the tensor-core kernel on the card, which never
    writes the chunk's bits; on the CPU the unpack and the int8 product);
    the products are the scratch, one chunk's worth, released between
    steps."""

    words: torch.Tensor  # int32 [N, G, W] bit patterns of the uint32 words
    popc: torch.Tensor   # int32 [N] popcount per point


def unpack_bits_numpy(codes: np.ndarray, code_bits: int) -> np.ndarray:
    """uint32 packed words [N, G, W] → int8 bit matrix [N, G*code_bits].

    Word packing is MSB-first (ops/coding.py), so big-endian byte view +
    ``np.unpackbits`` reproduces the bit order; each group's trailing pad
    bits (W*32 - code_bits) are dropped.
    """
    n, g, w = codes.shape
    by = np.ascontiguousarray(codes.astype(">u4")).view(np.uint8)
    bits = np.unpackbits(by.reshape(n, g, w * 4), axis=-1)  # [N, G, W*32]
    return np.ascontiguousarray(
        bits[:, :, :code_bits].reshape(n, g * code_bits)).astype(np.int8)


def _word_bytes(words: torch.Tensor) -> torch.Tensor:
    """int32 word bit patterns [..., W] (or int64 holding the same low 32
    bits) → their big-endian bytes, uint8 [..., W*4].  Nothing wider than
    the words is made: the words are reinterpreted as bytes and each word's
    four bytes reversed on a little-endian host."""
    w32 = words.to(torch.int32).contiguous()
    by = w32.view(torch.uint8).reshape(*w32.shape, 4)
    if sys.byteorder == "little":
        by = by.flip(-1)
    return by.reshape(*w32.shape[:-1], w32.shape[-1] * 4)


def unpack_bits_device(codes: torch.Tensor, code_bits: int) -> torch.Tensor:
    """Device-side unpack: int32 or int64 word bit patterns [..., G, W] →
    int8 [..., G*code_bits], the MSB-first convention of
    :func:`unpack_bits_numpy`.  Every operand is one byte wide: the scratch
    is the words' bytes plus the bits (8 per byte)."""
    g = codes.shape[-2]
    by = _word_bytes(codes)                                 # [..., G, W*4]
    # the shifts that bring a byte's bits out MSB first, made on the device
    # (a host constant would cost a blocking copy per chunk)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=codes.device)
    bits = by[..., None] >> shifts                          # [..., G, W*4, 8]
    bits = bits.bitwise_and_(1).view(torch.int8)
    bits = bits.reshape(*codes.shape[:-1], -1)[..., :code_bits]
    return bits.reshape(*codes.shape[:-2], g * code_bits)


def _popcounts(words: torch.Tensor, chunk: int) -> torch.Tensor:
    """int32 [N] popcounts of word bit patterns [N, ...], by a byte lookup
    table (indexed in int32) over ``chunk`` rows at a time (pad bits are
    zero by the packers' construction, ops/coding.py, so they equal the
    bit-matrix row sums)."""
    n = words.shape[0]
    popc = torch.empty(n, dtype=torch.int32, device=words.device)
    popc8 = _POPC8.to(words.device)
    for lo in range(0, n, chunk):
        w = words[lo:lo + chunk]
        popc[lo:lo + len(w)] = popc8[_word_bytes(w).to(torch.int32)].reshape(
            len(w), -1).sum(dim=1, dtype=torch.int32)
    return popc


def build_scan_state(codes: np.ndarray, code_bits: int,
                     chunk: int = 65_536, *, device=None) -> ScanState:
    """Upload the PACKED words chunk by chunk and unpack ON DEVICE into a
    preallocated int8 bit matrix (8× fewer bytes cross the host link than
    a host unpack; the device peak is the matrix plus one chunk's
    scratch).  Popcounts come from a byte lookup table over the same
    words (pad bits are zero by the packers' construction, ops/coding.py).
    Bit-identical to :func:`unpack_bits_numpy`."""
    device = torch.device(device) if device is not None else torch.device(
        "cpu")
    n, g, _w = codes.shape
    bits = torch.empty((n, g * code_bits), dtype=torch.int8, device=device)
    popc = torch.empty(n, dtype=torch.int32, device=device)
    for lo in range(0, n, chunk):
        words = words_to_torch(codes[lo:lo + chunk], device)
        bits[lo:lo + len(words)] = unpack_bits_device(words, code_bits)
        popc[lo:lo + len(words)] = _popcounts(words, chunk)
    return ScanState(bits, popc)


def build_scan_state_packed(codes: np.ndarray, code_bits: int, *,
                            device=None,
                            chunk: int = 65_536) -> PackedScanState:
    """Upload the packed words as int32 bit patterns (4 bytes per 32 code
    bits; the scan unpacks them one chunk at a time) and take their
    popcounts on the device in ``chunk``-row steps.
    ``code_bits`` is the JAX signature's; the words carry their width."""
    del code_bits
    words = words_to_torch(codes, device if device is not None else "cpu")
    return PackedScanState(words, _popcounts(words, chunk))


def update_rows(buf: torch.Tensor, new: torch.Tensor, lo: int
                ) -> torch.Tensor:
    """In-place row fill of a capacity-padded scan state: ``buf[lo:lo +
    len(new)] = new``.  The tensor keeps its storage and shape (the JAX
    version donates the buffer to the same end), so a stream of live
    inserts never copies the resident state.  Returns ``buf``."""
    buf[lo:lo + len(new)].copy_(new)
    return buf


def _bit_dots(qbits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Exact ``qbits @ bits.T``: int8 [Q, B] × int8 [N, B] → int32 [Q, N]."""
    if bits.device.type != "cuda":
        return torch._int_mm(qbits, bits.t())
    q, b = qbits.shape
    n = bits.shape[0]
    if b % 8:
        raise ValueError(f"the CUDA scan needs a code width that is a "
                         f"multiple of 8 bits, got {b}")
    qp = max(24, -(-q // 8) * 8)
    if qp != q:
        qbits = torch.cat([qbits, qbits.new_zeros((qp - q, b))])
    n8 = n - n % 8
    dots = torch._int_mm(qbits, bits[:n8].t()) if n8 else None
    if n8 < n:
        # < 8 rows: sums of 0/1 products <= B < 2^24 are exact in float32
        tail = (qbits.float() @ bits[n8:].float().t()).to(torch.int32)
        dots = tail if dots is None else torch.cat([dots, tail], dim=1)
    return dots[:q]


def _products(qbits: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int32 [Q, C] bit products of the query bits and ``rows``: int8 bits
    [C, B], or packed words [C, G, W] (``ops/packed_dots``, ``B / G`` code
    bits a group).  Counts the rows scored (``scan.rows``) and, packed,
    those scored from the words (``scan.packed_rows``) under the open
    request."""
    count("scan.rows", len(rows))
    if rows.dim() == 3:
        count("scan.packed_rows", len(rows))
        return packed_dots(qbits, rows, qbits.shape[1] // rows.shape[1])
    return _bit_dots(qbits, rows)


def _adaptive_count(scores: torch.Tensor, anchor: int, margin: int,
                    floor: int, k: int) -> torch.Tensor:
    """Per-query adaptive decrypt budget from the ranked score matrix.

    ``scores`` is int32 [Q, L] ascending (best first), dead/pad = _INF.
    Budget = how many candidates sit within ``margin`` Hamming bits of the
    ``anchor``-th best score, clamped to [floor, L].  When fewer than
    ``anchor`` candidates are live the threshold clamp counts every live
    row.  Rows beyond the margin are statistically never promoted into the
    top-k by the exact-distance refine, so decrypting them is wasted host
    AES.
    """
    a = max(min(anchor, k), 1)
    s_a = scores[:, a - 1]
    # overflow guard: s_a == _INF (fewer than `a` live) must still count
    # all live rows, not wrap around
    thresh = torch.clamp(s_a, max=_INF - margin - 1) + margin
    n_dec = (scores <= thresh[:, None]).sum(dim=-1, dtype=torch.int32)
    return torch.clamp(n_dec, min(max(floor, a), k), k)


def _finish(best_sc: torch.Tensor, best_id: torch.Tensor, qbits, n: int,
            anchor: int, margin: int, floor: int, k: int) -> RouteResult:
    live = best_sc < _DEAD
    qpopc = qbits.to(torch.int32).sum(dim=1, dtype=torch.int32)
    scores = torch.where(live, best_sc + qpopc[:, None],
                         torch.full_like(best_sc, _INF))
    ids = torch.where(live, best_id, torch.full_like(best_id, -1))
    n_live = live.sum(dim=-1, dtype=torch.int32)
    n_dec = _adaptive_count(scores, anchor, margin, floor, k) \
        if margin > 0 else None
    return RouteResult(ids, scores, n_live, torch.full_like(n_live, n), n_dec)


def _select(dots: torch.Tensor, popc: torch.Tensor, dead: torch.Tensor,
            k: int, row0: int, approx: bool, width: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest ``(popc - 2 * dots, row)`` pairs (``_DEAD`` at
    ``dead`` columns, rows ``row0 + column``): exact, or approximate with
    ``approx`` (``ops/approx_topk``: on the card the kernel forms the rank
    value as it reads the products; the bins are those of a ``width``-row
    block that the columns end)."""
    if approx:
        return approx_rank_topk(dots, k, row0, popc=popc, scale=-2,
                                dead=dead, width=width)
    part = dots.mul_(-2).add_(popc)                      # rank key
    part.masked_fill_(dead[None, :], _DEAD)
    return _rank_topk(part, k, row0)


def scan(state: ScanState, qbits: torch.Tensor, tombstones: torch.Tensor,
         limit: int, approx: bool = True, anchor: int = 0, margin: int = 0,
         floor: int = 0) -> RouteResult:
    """Global fine-Hamming ranking: top-``limit`` ids per query.

    Args:
      state: corpus bit matrix + popcounts.
      qbits: int8 [Q, B] unpacked query code bits, on the state's device.
      tombstones: bool [N] deleted mask.
      limit: L — decrypt budget per query.
      approx: select with ``approx_topk.approx_rank_topk`` (the TPU's
        ``lax.approx_max_k`` at recall_target 0.98: each true top-L
        element kept with ~98% probability; exact on a CPU tensor).
        ``False`` = the exact top-L.
      anchor/margin/floor: when ``margin`` > 0, also return a per-query
        adaptive decrypt budget (:func:`_adaptive_count`) in
        ``RouteResult.n_dec``.
    """
    return _scan(state.bits, state.popc, qbits, tombstones, limit, approx,
                 anchor, margin, floor)


def _scan(rows: torch.Tensor, popc: torch.Tensor, qbits: torch.Tensor,
          tombstones: torch.Tensor, limit: int, approx: bool, anchor: int,
          margin: int, floor: int) -> RouteResult:
    """:func:`scan` over ``rows`` in either layout (:func:`_products`)."""
    n = rows.shape[0]
    k = min(limit, n)
    with span("scan.products"):
        dots = _products(qbits, rows)
    with span("scan.select"):
        sc, idx = _select(dots, popc, tombstones, k, 0, approx)
    with span("scan.finish"):
        return _finish(sc, idx, qbits, n, anchor, margin, floor, k)


def scan_chunk_merge(qbits: torch.Tensor, bits_c: torch.Tensor,
                     popc_c: torch.Tensor, dead_c: torch.Tensor, start: int,
                     start_c: int, carry: tuple, approx: bool,
                     width: int | None = None) -> tuple:
    """One chunked-scan step: score ``bits_c`` (int8 bits [chunk, B], or
    int32 words [chunk, G, W] scored straight from the words) against
    ``qbits``, mask dead + tail-duplicate rows (``start_c`` is the clamped
    slice origin; rows with index < ``start`` were already scanned), take
    the chunk top-k, and 2-key-merge (score, id) into the running carry.
    With ``approx`` the top-k bins as a ``width``-row block (default: the
    block's own rows) that ends with this one, as the JAX package bins its
    whole-chunk tail block (``approx_topk``)."""
    best_sc, best_id = carry
    k = best_sc.shape[1]
    chunk = bits_c.shape[0]
    ridx = start_c + torch.arange(chunk, dtype=torch.int64,
                                  device=popc_c.device)
    sc, cid = _select(_products(qbits, bits_c), popc_c,
                      dead_c | (ridx < start), k, start_c, approx, width)
    cid = torch.where(sc < _DEAD, cid, torch.full_like(cid, -1))
    # merge with carry: rank (score, id) over the 2k union; dead entries
    # carry id -1, which the signed key orders like the 2-key sort
    msc = torch.cat([best_sc, sc], dim=1)
    mid = torch.cat([best_id, cid], dim=1)
    key = (msc.to(torch.int64) << 32) + mid.to(torch.int64)
    sel = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
    return msc.gather(1, sel), mid.gather(1, sel)


def scan_chunks(rows: torch.Tensor, popc: torch.Tensor, dead: torch.Tensor,
                qbits: torch.Tensor, limit: int, chunk: int, *,
                approx: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The running top-k loop of the chunked scan, shared by
    :func:`scan_chunked` and the sharded packed step
    (``parallel/sharded.scan_route_step_fn_packed``): ``rows`` (int8 bits
    [n, B], or int32 words [n, G, W], scored from the words) go through
    :func:`scan_chunk_merge` in ``chunk``-row blocks.  Returns the carry
    ``(part int32 [Q, k], row int32 [Q, k])``, ``k = min(limit, chunk,
    n)``, dead entries ``(_DEAD, -1)``.

    Every block's approximate selection bins as the JAX package's
    ``chunk``-row block (``width=chunk``).  JAX scans its tail as a whole
    block from ``n - chunk`` with the rows already scanned masked DEAD; the
    tail here is the ``left`` rows past them, binned at the offset ``chunk
    - left`` without reading the dead rows (``approx_rank_topk`` takes the
    exact top-k where ``left <= W``: every live row of JAX's block then
    sits alone in a bin).  Only when ``left < k`` (the exact top-k needs
    ``k`` columns) does the tail block start at ``n - chunk`` and re-read
    scanned rows, masked DEAD: JAX's block itself."""
    n = popc.shape[0]
    q = qbits.shape[0]
    k = min(limit, chunk, n)
    dev = popc.device
    carry = (torch.full((q, k), _DEAD, dtype=torch.int32, device=dev),
             torch.full((q, k), -1, dtype=torch.int32, device=dev))
    for start in range(0, n, chunk):
        start_c = start if n - start >= k else n - chunk
        sl = slice(start_c, min(start_c + chunk, n))
        carry = scan_chunk_merge(qbits, rows[sl], popc[sl], dead[sl], start,
                                 start_c, carry, approx=approx, width=chunk)
    return carry


def scan_chunked(state: ScanState | PackedScanState, qbits: torch.Tensor,
                 tombstones: torch.Tensor, limit: int, chunk: int = 1 << 19,
                 approx: bool = True, anchor: int = 0, margin: int = 0,
                 floor: int = 0, code_bits: int = 0) -> RouteResult:
    """:func:`scan` with the corpus processed in ``chunk``-row blocks and a
    running top-L merge (:func:`scan_chunks`) — the [Q, N] rank intermediate
    becomes [Q, chunk], so memory stays flat as N grows.

    With a :class:`PackedScanState` (pass ``code_bits``) each chunk is
    scored straight from its words (``ops/packed_dots``); the packed words
    are what stays resident.  The merge orders by (score, id),
    matching :func:`scan`.  With ``approx`` each block is selected
    approximately over the chunk's width, the tail as the JAX package's
    whole-chunk tail block (:func:`scan_chunks`), and the merge stays
    exact.
    """
    packed = isinstance(state, PackedScanState)
    if packed and code_bits <= 0:
        raise ValueError("PackedScanState requires code_bits")
    if packed and qbits.shape[1] != state.words.shape[1] * code_bits:
        raise ValueError(f"query bits [{qbits.shape[1]}] do not match "
                         f"{state.words.shape[1]} groups of {code_bits} bits")
    rows = state.words if packed else state.bits
    n = state.popc.shape[0]
    if n <= chunk:
        return _scan(rows, state.popc, qbits, tombstones, limit, approx,
                     anchor, margin, floor)
    carry = scan_chunks(rows, state.popc, tombstones, qbits, limit, chunk,
                        approx=approx)
    return _finish(*carry, qbits, n, anchor, margin, floor, carry[0].shape[1])
