"""Shared value types (host-side dataclasses; device state lives in pytrees).

Counterparts of the reference's ``common`` module records:
``EncryptedPoint`` (common/EncryptedPoint.java), ``QueryToken``
(common/QueryToken.java), ``QueryResult``, ``KeyVersion``, ``QueryMetrics``.
The TPU build stores routing codes as dense device arrays rather than on the
point record — an ``EncryptedPoint`` here is pure cipher state, which is what
keeps rotation orthogonal to routing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class EncryptedPoint:
    """One AES-256-GCM-encrypted vector payload.

    AAD binds identity, key version and dimension exactly like the reference
    (crypto/AesGcmCryptoService.java:72-83): ``id:{id}|v:{version}|d:{dim}``.
    ``ciphertext`` carries the GCM tag appended (ct || tag16).
    """

    id: int
    key_version: int
    iv: bytes            # 12 bytes
    ciphertext: bytes    # payload || 16-byte tag
    dimension: int

    @property
    def aad(self) -> bytes:
        return aad_for(self.id, self.key_version, self.dimension)


AAD_LEN = 32  # fixed-width — enables fully vectorized batch construction


def aad_for(point_id: int, key_version: int, dimension: int) -> bytes:
    """Fixed-width AAD (32 bytes).  Same binding as the reference
    (id | key version | dimension) with zero-padded decimal fields so a batch
    of AADs is one numpy digit-matrix fill instead of n Python formats."""
    return f"id:{point_id:010d}|v:{key_version:08d}|d:{dimension:05d}".encode()


def aad_batch(point_ids: "np.ndarray", key_versions: "np.ndarray | int",
              dimension: int) -> "np.ndarray":
    """uint8 [n, 32] AAD matrix, rows identical to aad_for()."""
    ids = np.asarray(point_ids, np.int64)
    n = len(ids)
    kvs = np.broadcast_to(np.asarray(key_versions, np.int64), (n,))
    out = np.empty((n, AAD_LEN), np.uint8)

    def digits(vals, start, width):
        pow10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
        out[:, start:start + width] = \
            (vals[:, None] // pow10) % 10 + ord("0")

    out[:, 0:3] = np.frombuffer(b"id:", np.uint8)
    digits(ids, 3, 10)
    out[:, 13:16] = np.frombuffer(b"|v:", np.uint8)
    digits(kvs, 16, 8)
    out[:, 24:27] = np.frombuffer(b"|d:", np.uint8)
    digits(np.full(n, dimension, np.int64), 27, 5)
    return out


@dataclass(frozen=True)
class QueryToken:
    """Client→server query: packed routing codes + encrypted query vector.

    ``codes`` is ``uint32[G, W]`` (G = tables*divisions packed code words) and
    ``keys`` is ``int64[G]`` — the 63-bit sortable prefixes.  The plaintext
    query never appears; the server decrypts ``encrypted_query`` under the
    token's key version (reference common/QueryToken.java + trusted-eval
    shortcut in query/QueryServiceImpl.java:131).
    """

    codes: np.ndarray        # uint32 [G, W]
    keys: np.ndarray         # int64 [G]
    iv: bytes
    encrypted_query: bytes   # ct || tag
    top_k: int
    dimension: int
    key_version: int
    num_tables: int
    lam: int
    # Deterministic digest of the plaintext query, computed CLIENT-side by
    # the token factory — the result-cache key (reference StringKeyedCache
    # keys by the query string).  Coarse LSH codes alone are NOT a valid
    # key: two nearby distinct queries can share codes (that is the point
    # of LSH) and would be served each other's exact distances.
    query_digest: bytes = b""

    def derive(self, top_k: int) -> "QueryToken":
        """Re-target topK only (reference QueryTokenFactory.derive:182-198)."""
        return QueryToken(self.codes, self.keys, self.iv, self.encrypted_query,
                          top_k, self.dimension, self.key_version,
                          self.num_tables, self.lam, self.query_digest)

    @property
    def cache_key(self) -> bytes:
        """Collision-free result-cache component: the query digest when the
        factory provided one, else the (IV, ciphertext) pair — unique per
        encryption, so a digest-less token never aliases another query."""
        return self.query_digest or self.iv + self.encrypted_query


@dataclass(frozen=True)
class QueryResult:
    id: int
    distance: float


@dataclass(frozen=True)
class QueryMetrics:
    """Paper metrics at K (reference common/QueryMetrics.java:7-21)."""

    candidate_ratio_at_k: float
    distance_ratio_at_k: float
    recall_at_k: float


@dataclass
class SearchStats:
    """Per-query pipeline counters (reference QueryServiceImpl getters:417-475).

    The port's query service also fills, from its spans, each query's share
    of its batch's: stage-A dispatch and the host's wait on the card
    (``route_ns == dispatch_ns + wait_ns``), the server's token open, the
    store's metadata lookup and AES-GCM open (both inside ``decrypt_ns``),
    the device refine's upload, the touched-set tracking, and stage A's
    time on the card between two CUDA events (only while a
    ``torch.profiler`` records; None otherwise).  A retried query carries
    both of its passes."""

    cand_raw: int = 0
    cand_unique: int = 0
    cand_refined: int = 0
    cand_decrypted: int = 0
    returned: int = 0
    retried: bool = False
    server_ns: int = 0
    decrypt_ns: int = 0
    route_ns: int = 0
    refine_ns: int = 0
    touched_ids: list = field(default_factory=list)
    dispatch_ns: int = 0
    wait_ns: int = 0
    token_open_ns: int = 0
    lookup_ns: int = 0
    open_ns: int = 0
    upload_ns: int = 0
    track_ns: int = 0
    stage_a_device_ns: int | None = None
