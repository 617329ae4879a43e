"""Decoy query generation — access-pattern obfuscation.

Reference counterpart: ``query/core/DecoyQueryGenerator.java`` — inject
synthetic queries (uniform / gaussian / clustered, normalized), count drawn
Poisson-style with jitter, shuffled into the real stream (:60-130); opt-in
(reference flag ``-Ddecoy.enabled``, ForwardSecureANNSystem.java:172-183).
"""

from __future__ import annotations

import numpy as np


class DecoyGenerator:
    def __init__(self, dim: int, rate: float = 0.3, seed: int = 1789,
                 mode: str = "gaussian"):
        if mode not in ("gaussian", "uniform", "clustered"):
            raise ValueError(f"unknown decoy mode {mode!r}")
        self.dim = dim
        self.rate = rate
        self.mode = mode
        self.rng = np.random.default_rng(seed)

    def generate(self, n: int, reference: np.ndarray | None = None
                 ) -> np.ndarray:
        """n synthetic queries, normalized to the reference scale."""
        if self.mode == "uniform":
            out = self.rng.uniform(-1, 1, (n, self.dim))
        elif self.mode == "clustered" and reference is not None and len(reference):
            picks = reference[self.rng.integers(0, len(reference), n)]
            out = picks + self.rng.normal(0, 0.05, (n, self.dim))
        else:
            out = self.rng.normal(0, 1, (n, self.dim))
        out = out.astype(np.float32)
        if reference is not None and len(reference):
            scale = float(np.linalg.norm(reference, axis=1).mean())
            norms = np.linalg.norm(out, axis=1, keepdims=True)
            out = out / np.maximum(norms, 1e-9) * scale
        return out

    def interleave(self, queries: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Shuffle decoys into the real stream.  Returns (mixed, real_src):
        ``real_src[i]`` is the ORIGINAL index of ``mixed[i]`` in ``queries``
        (so evaluation can look up ground truth for real queries while
        decoys flow through the full pipeline — reference
        DecoyQueryGenerator.java:91 keeps the real positions), or -1 for an
        injected decoy.  ``real_src >= 0`` recovers the boolean mask.

        Decoy count ≈ Poisson(rate · n) with jitter (reference :91-130).
        """
        n = len(queries)
        n_decoys = int(self.rng.poisson(max(self.rate * n, 1e-9)))
        decoys = self.generate(n_decoys, queries)
        mixed = np.concatenate([queries, decoys]) if n_decoys else \
            np.asarray(queries)
        src = np.concatenate([np.arange(n, dtype=np.int64),
                              np.full(n_decoys, -1, np.int64)])
        perm = self.rng.permutation(len(mixed))
        return mixed[perm], src[perm]
