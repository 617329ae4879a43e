"""QueryToken construction (reference query/core/QueryTokenFactory.java).

A token carries (a) packed routing codes for every (table, division) group —
computed with the SAME bank as the index, hard-checked (:79-88) — and (b) the
query vector AES-GCM-encrypted under the current key with a fresh IV
(:149-166).  ``derive`` re-targets topK without re-encrypting (:182-198).
"""

from __future__ import annotations

import hashlib
import secrets

import numpy as np

from ..crypto.keys import KeyManager
from ..index.service import PartitionedIndex
from ..types import QueryToken
from ..utils.profiler import span


class QueryTokenFactory:
    def __init__(self, index: PartitionedIndex, km: KeyManager, dim: int):
        self.index = index
        self.km = km
        self.dim = dim

    def create(self, query: np.ndarray, top_k: int) -> QueryToken:
        return self.create_batch(np.asarray(query, np.float32)[None, :],
                                 top_k)[0]

    def create_batch(self, queries: np.ndarray, top_k: int
                     ) -> list[QueryToken]:
        """Encode all queries in one device batch; encrypt each under the
        current key version with a fresh IV."""
        with span("token.create"):
            queries = np.asarray(queries, np.float32)
            if queries.ndim != 2 or queries.shape[1] != self.dim:
                raise ValueError(f"expected [*, {self.dim}] queries, "
                                 f"got {queries.shape}")
            if not np.isfinite(queries).all():
                raise ValueError("query contains NaN/Inf")
            bank = self.index.bank
            if bank is None:
                raise RuntimeError("token factory requires an initialized "
                                   "bank (index must have seen its sample)")
            with span("token.encode"):
                qc, qk = self.index.encode_queries(queries)
                qc, qk = np.asarray(qc), np.asarray(qk)
            with span("token.seal"):
                kv = self.km.current_version
                gcm = self.km.gcm_for(kv)
                n = len(queries)
                body = 4 * self.dim
                # ONE batched seal for the whole token batch (the per-token
                # Python seal loop was ~0.04 ms/q of interpreter+ctypes
                # overhead at serving rates); IVs from one urandom read,
                # still unique per token
                from ..crypto import aesgcm

                ivs = np.frombuffer(secrets.token_bytes(12 * n),
                                    np.uint8).reshape(n, 12)
                pt_flat = np.ascontiguousarray(queries.astype("<f4")).view(
                    np.uint8).reshape(-1)
                offs = np.arange(n, dtype=np.uint64) * body
                lens = np.full(n, body, np.uint64)
                ct_flat, tags = aesgcm.seal_batch(gcm, ivs, [b""] * n,
                                                  pt_flat, offs, lens)
                out = []
                for i in range(n):
                    pt = pt_flat[i * body:(i + 1) * body].tobytes()
                    ct = ct_flat[i * body:(i + 1) * body].tobytes() \
                        + tags[i].tobytes()
                    out.append(QueryToken(
                        codes=qc[i], keys=qk[i], iv=ivs[i].tobytes(),
                        encrypted_query=ct,
                        top_k=top_k, dimension=self.dim, key_version=kv,
                        num_tables=bank.tables, lam=bank.lam,
                        query_digest=hashlib.blake2b(
                            pt, digest_size=16).digest()))
                return out
