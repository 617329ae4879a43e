"""Hamming scan: full-corpus fine-score ranking as an int8 bit matmul.

    Hamming(q, c) = popcount(q) + popcount(c) - 2 * <bits(q), bits(c)>

so ranking by Hamming is ranking by ``popc[c] - 2 * dot`` — one
``[Q, B] x [B, N]`` int8→int32 product (B = G·m·λ total code bits) plus a
top-L.  This replaces the reference's whole stage-A machinery (probe queue
over partitions, PartitionedIndexService.java:592-715) with an exact global
fine ranking.  Device memory: N·B int8 bytes (3.07 GB at 1M × 3,072 bits).

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

from typing import NamedTuple

import numpy as np
import torch

from .routing import _INF, RouteResult

# dead-entry sentinel for the rank key: far above any real rank value
# (|part| <= B <= a few thousand); the JAX package's value
_DEAD = 1 << 30

# byte -> its 8 bits, MSB first; byte -> popcount
_BITS8 = torch.tensor(np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                                    axis=1).astype(np.int8))
_POPC8 = _BITS8.sum(dim=1, dtype=torch.int32)


class ScanState(NamedTuple):
    bits: torch.Tensor   # int8 [N, B] unpacked 0/1 code bits (MSB-first order)
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
    """int64 word bit patterns [..., W] → big-endian byte values
    [..., W*4] (int64 in [0, 256)).  Words ride as int64 because ``>>`` on
    ``torch.uint32`` is not implemented on every device."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=words.device)
    by = (words[..., None] >> shifts) & 0xFF
    return by.reshape(*words.shape[:-1], words.shape[-1] * 4)


def unpack_bits_device(words: torch.Tensor, code_bits: int) -> torch.Tensor:
    """Device-side unpack: int64 word bit patterns [..., G, W] → int8
    [..., G*code_bits], the MSB-first convention of
    :func:`unpack_bits_numpy` (a byte → 8-bit lookup table)."""
    g = words.shape[-2]
    bits = _BITS8.to(words.device)[_word_bytes(words)]      # [..., G, W*4, 8]
    bits = bits.reshape(*words.shape[:-1], -1)[..., :code_bits]
    return bits.reshape(*words.shape[:-2], g * code_bits)


def _words_to_device(codes: np.ndarray, device) -> torch.Tensor:
    """uint32 [n, G, W] numpy words → int64 bit patterns on ``device``."""
    w32 = torch.from_numpy(np.ascontiguousarray(codes, np.uint32)
                           .view(np.int32))
    return w32.to(device).to(torch.int64) & 0xFFFFFFFF


def build_scan_state(codes: np.ndarray, code_bits: int,
                     device=None, chunk: int = 65_536) -> ScanState:
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
    popc8 = _POPC8.to(device)
    for lo in range(0, n, chunk):
        words = _words_to_device(codes[lo:lo + chunk], device)
        bits[lo:lo + len(words)] = unpack_bits_device(words, code_bits)
        popc[lo:lo + len(words)] = popc8[_word_bytes(words)].reshape(
            len(words), -1).sum(dim=1, dtype=torch.int32)
    return ScanState(bits, popc)


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


def _rank_topk(part: torch.Tensor, k: int, row0: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest ``(part, row)`` pairs of each row of ``part``
    (int32 [Q, C]; row ids ``row0 + column``), ascending — the order of
    ``lax.top_k(-part)``, which keeps the lower index first on ties.
    Returns (part int32 [Q, k], row int32 [Q, k])."""
    key = part.to(torch.int64)
    key <<= 32
    key |= torch.arange(row0, row0 + part.shape[1], dtype=torch.int64,
                        device=part.device)
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


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


def scan(state: ScanState, qbits: torch.Tensor, tombstones: torch.Tensor,
         limit: int, anchor: int = 0, margin: int = 0,
         floor: int = 0) -> RouteResult:
    """Global fine-Hamming ranking: top-``limit`` ids per query, exact.

    Args:
      state: corpus bit matrix + popcounts.
      qbits: int8 [Q, B] unpacked query code bits, on the state's device.
      tombstones: bool [N] deleted mask.
      limit: L — decrypt budget per query.
      anchor/margin/floor: when ``margin`` > 0, also return a per-query
        adaptive decrypt budget (:func:`_adaptive_count`) in
        ``RouteResult.n_dec``.
    """
    n = state.bits.shape[0]
    part = _bit_dots(qbits, state.bits).mul_(-2).add_(state.popc)  # rank key
    part.masked_fill_(tombstones[None, :], _DEAD)
    k = min(limit, n)
    sc, idx = _rank_topk(part, k)
    return _finish(sc, idx, qbits, n, anchor, margin, floor, k)


def scan_chunk_merge(qbits: torch.Tensor, bits_c: torch.Tensor,
                     popc_c: torch.Tensor, dead_c: torch.Tensor, start: int,
                     start_c: int, carry: tuple) -> tuple:
    """One chunked-scan step: score ``bits_c`` (int8 [chunk, B]) against
    ``qbits``, mask dead + tail-duplicate rows (``start_c`` is the clamped
    slice origin; rows with index < ``start`` were already scanned), take
    the chunk top-k, and 2-key-merge (score, id) into the running carry."""
    best_sc, best_id = carry
    k = best_sc.shape[1]
    chunk = bits_c.shape[0]
    part = _bit_dots(qbits, bits_c).mul_(-2).add_(popc_c)    # [Q, chunk]
    ridx = start_c + torch.arange(chunk, dtype=torch.int64,
                                  device=part.device)
    part.masked_fill_((dead_c | (ridx < start))[None, :], _DEAD)
    sc, cid = _rank_topk(part, k, start_c)
    cid = torch.where(sc < _DEAD, cid, torch.full_like(cid, -1))
    # merge with carry: rank (score, id) over the 2k union; dead entries
    # carry id -1, which the signed key orders like the 2-key sort
    msc = torch.cat([best_sc, sc], dim=1)
    mid = torch.cat([best_id, cid], dim=1)
    key = (msc.to(torch.int64) << 32) + mid.to(torch.int64)
    sel = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
    return msc.gather(1, sel), mid.gather(1, sel)


def scan_chunked(state: ScanState, qbits: torch.Tensor,
                 tombstones: torch.Tensor, limit: int, chunk: int = 1 << 19,
                 anchor: int = 0, margin: int = 0,
                 floor: int = 0) -> RouteResult:
    """:func:`scan` with the corpus processed in ``chunk``-row blocks and a
    running top-L merge — the [Q, N] rank intermediate becomes [Q, chunk],
    so memory stays flat as N grows.

    The tail block starts at ``n - chunk`` and re-reads already-scanned
    rows; those duplicates are masked DEAD so every id appears at most
    once.  The merge orders by (score, id), matching :func:`scan`.
    """
    n = state.bits.shape[0]
    if n <= chunk:
        return scan(state, qbits, tombstones, limit, anchor, margin, floor)
    q = qbits.shape[0]
    k = min(limit, chunk, n)
    dev = state.bits.device
    carry = (torch.full((q, k), _DEAD, dtype=torch.int32, device=dev),
             torch.full((q, k), -1, dtype=torch.int32, device=dev))
    for start in range(0, n, chunk):
        start_c = min(start, n - chunk)
        sl = slice(start_c, start_c + chunk)
        carry = scan_chunk_merge(qbits, state.bits[sl], state.popc[sl],
                                 tombstones[sl], start, start_c, carry)
    return _finish(*carry, qbits, n, anchor, margin, floor, k)
