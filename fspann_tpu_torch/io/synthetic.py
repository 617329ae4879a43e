"""LSH-hard synthetic benchmark corpora.

Real SIFT1M/GIST1M files are not fetchable in this environment, and a
well-separated isotropic Gaussian mixture (round-1 bench) is an EASY LSH
instance — recall saturates at ~1.0 and proves nothing.  This module builds
instances with the properties that make real descriptor datasets hard for
LSH routing (the reference's measured recall@100 on real SIFT is 0.55–0.77,
`fsp-anns-parent/logs/New Results:18-54` in the reference repository):

* **Low intrinsic dimensionality with correlated dimensions** — points live
  near a rank-``d_eff`` manifold (x = z @ W), like real descriptors, so
  random projections are far more redundant than in an isotropic cloud.
* **Heavy-tailed cluster sizes** (Zipf) — a few huge clusters plus a long
  tail, so partition occupancy is skewed exactly the way real corpora skew
  greedy partitions.
* **Overlapping clusters with varied radii** — the center spread over the
  intra-cluster radius (``separation``) controls difficulty directly;
  at ~1–2 the Voronoi structure barely exists and near neighbors straddle
  bucket boundaries.
* **Fringe queries** — each query perturbs a real corpus point by
  ``query_alpha`` × its cluster radius, so the true NN sits at a controlled
  distance ratio to distractors from competing clusters (a planted-neighbor
  construction: alpha≈0 trivial, alpha≳1 adversarial).

The default parameters are calibrated (scripts/calibrate_hard.py) so the
default profile lands meaningfully below 1.0 recall at 1M scale — a real
measurement of the routing quality/latency trade-off, not a gimme.
"""

from __future__ import annotations

import numpy as np


def _zipf_sizes(rng: np.random.Generator, n_clusters: int, n: int,
                a: float) -> np.ndarray:
    """Cluster sizes with a Zipf(a) profile summing exactly to n."""
    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    w = ranks ** (-a)
    rng.shuffle(w)
    sizes = np.floor(w / w.sum() * n).astype(np.int64)
    sizes = np.maximum(sizes, 1)
    # distribute the rounding remainder over random clusters
    extra = n - int(sizes.sum())
    if extra > 0:
        idx = rng.choice(n_clusters, extra, replace=True)
        np.add.at(sizes, idx, 1)
    elif extra < 0:
        for _ in range(-extra):
            c = rng.integers(0, n_clusters)
            while sizes[c] <= 1:
                c = rng.integers(0, n_clusters)
            sizes[c] -= 1
    return sizes


def lsh_hard_corpus(n: int, d: int, n_queries: int, seed: int = 42,
                    d_eff: int | None = None,
                    n_clusters: int | None = None,
                    zipf_a: float = 1.1,
                    separation: float = 1.6,
                    radius_sigma: float = 0.35,
                    ambient_noise: float = 0.15,
                    query_alpha: float = 0.9,
                    chunk: int = 200_000
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Build (base [n, d] f32, queries [n_queries, d] f32).

    separation: cluster-center spread measured in units of the mean
      intra-cluster radius.  ~4+ is easy (round-1 corpus ≈ 6); ~1.5 is hard.
    query_alpha: query offset from its anchor point, in units of the
      anchor cluster's radius.
    """
    rng = np.random.default_rng(seed)
    d_eff = d_eff or max(8, d // 4)
    n_clusters = n_clusters or max(64, n // 1000)

    # correlated-dimension mixing matrix (row-orthonormalized)
    w_mix = rng.normal(size=(d_eff, d)).astype(np.float32)
    q_mat, _ = np.linalg.qr(w_mix.T)
    w_mix = np.ascontiguousarray(q_mat[:, :d_eff].T, dtype=np.float32)

    sizes = _zipf_sizes(rng, n_clusters, n, zipf_a)
    # per-cluster radius: lognormal spread around 1; expected point norm in
    # the d_eff-dim latent is ~sqrt(d_eff), so scale centers to `separation`
    # times the mean radius for controlled overlap
    radii = np.exp(rng.normal(0.0, radius_sigma, n_clusters)
                   ).astype(np.float32)
    centers_latent = rng.normal(size=(n_clusters, d_eff)).astype(np.float32)
    centers_latent *= (separation * radii.mean()
                       / np.sqrt(2.0))   # center pair distance ~ sep * radius
    assignments = np.repeat(np.arange(n_clusters), sizes)
    rng.shuffle(assignments)

    base = np.empty((n, d), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        asg = assignments[s:e]
        z = (centers_latent[asg]
             + rng.normal(size=(e - s, d_eff)).astype(np.float32)
             * radii[asg, None])
        base[s:e] = z @ w_mix
        # full-rank ambient noise so the corpus is not exactly low-rank
        base[s:e] += rng.normal(size=(e - s, d)).astype(np.float32) \
            * ambient_noise

    # fringe queries: perturb real corpus points by alpha * cluster radius
    anchor_idx = rng.integers(0, n, n_queries)
    anchor_cluster = assignments[anchor_idx]
    delta = rng.normal(size=(n_queries, d)).astype(np.float32)
    delta /= np.linalg.norm(delta, axis=1, keepdims=True)
    # comparable scale to one latent std in ambient space: radius * sqrt(d_eff)
    offset = (query_alpha * radii[anchor_cluster]
              * np.sqrt(d_eff)).astype(np.float32)
    queries = base[anchor_idx] + delta * offset[:, None]
    return base, queries.astype(np.float32)


def glove_like_corpus(n: int, d: int = 100, n_queries: int = 1000,
                      seed: int = 42, spectrum: float = 1.25,
                      norm_sigma: float = 0.55,
                      chunk: int = 200_000
                      ) -> tuple[np.ndarray, np.ndarray]:
    """GloVe-100-class instance: anisotropic heavy-tailed embedding cloud
    with corpus-like (held-out) queries.

    Real GloVe-100 is the reference's second-hardest measured family (best
    recall@100 0.2717 at 3.6 s ART, `logs/New Results:76-80`) for reasons an
    isotropic mixture cannot reproduce:

    * **Power-law variance spectrum** — word-embedding variance concentrates
      in a few directions (``sigma_i ∝ i^-spectrum``), so most of the m
      random projections land in low-variance subspace and carry almost no
      routing information.
    * **Lognormal norm spread** (word frequency) — L2 distances stretch
      along the norm axis, breaking bucket widths calibrated on the bulk.
    * **Held-out queries** — a query is just another word: its k-NN distance
      sits close to the mean distance (low relative contrast), unlike a
      planted-neighbor construction.

    Calibrated (scripts/calibrate_families.py) so the reference-shaped probe
    profiles land in the reference's measured recall@100 band (0.14–0.27)
    and respond to probes the same way.
    """
    rng = np.random.default_rng(seed)
    sig = np.arange(1, d + 1, dtype=np.float64) ** -spectrum
    sig = (sig / np.sqrt((sig ** 2).mean())).astype(np.float32)
    q_mat, _ = np.linalg.qr(rng.normal(size=(d, d)))
    rot = np.ascontiguousarray(q_mat, dtype=np.float32)
    total = n + n_queries
    out = np.empty((total, d), np.float32)
    for s in range(0, total, chunk):
        e = min(s + chunk, total)
        z = rng.normal(size=(e - s, d)).astype(np.float32) * sig
        norms = np.exp(rng.normal(0.0, norm_sigma, e - s)).astype(np.float32)
        out[s:e] = (z @ rot) * norms[:, None]
    return out[:n], np.ascontiguousarray(out[n:])


def redcaps_like_corpus(n: int, d: int = 512, n_queries: int = 1000,
                        seed: int = 42, d_eff: int = 512,
                        spectrum: float = 0.0, cone: float = 2.0,
                        chunk: int = 200_000
                        ) -> tuple[np.ndarray, np.ndarray]:
    """RedCaps/CLIP-class instance: unit-norm 512-d embeddings on a narrow
    cone — the reference's hardest measured family (best recall@100 0.0969
    at 5.6 s ART, `logs/New Results:123-127`).

    The hardness mechanism is **distance concentration**: unit vectors in
    high dimension have pairwise cosines in a tight band around 0
    (measured std ≈ 0.04 at the default), so every L2 distance sits near
    sqrt(2), the k-NN distance is barely below the mean distance (measured
    relative contrast ≈ 0.91), and multi-probe LSH buckets are nearly
    uninformative — exactly the regime where the reference's own recall
    collapses to 0.04–0.10.

    ``cone`` adds a shared mean direction (the CLIP "cone effect"; it
    contributes cone²/(cone²+d_eff) of each vector's energy — a small
    positive cosine offset at the default), and ``d_eff``/``spectrum``
    admit anisotropic low-rank variants.  The calibrated default lands the
    reference-shaped profiles in the reference band at 1M
    (scripts/calibrate_families.py).  Queries are held-out draws (a
    cross-modal lookup is corpus-like).
    """
    rng = np.random.default_rng(seed)
    w_mix, _ = np.linalg.qr(rng.normal(size=(d, d_eff)))
    w_mix = np.ascontiguousarray(w_mix.T, dtype=np.float32)   # [d_eff, d]
    sig = np.arange(1, d_eff + 1, dtype=np.float64) ** -spectrum
    sig = (sig / np.sqrt((sig ** 2).mean())).astype(np.float32)
    mu_dir = rng.normal(size=d).astype(np.float32)
    mu = cone * mu_dir / np.linalg.norm(mu_dir)
    total = n + n_queries
    out = np.empty((total, d), np.float32)
    for s in range(0, total, chunk):
        e = min(s + chunk, total)
        z = rng.normal(size=(e - s, d_eff)).astype(np.float32) * sig
        x = z @ w_mix + mu
        out[s:e] = x / np.linalg.norm(x, axis=1, keepdims=True)
    return out[:n], np.ascontiguousarray(out[n:])


def easy_corpus(n: int, d: int, n_queries: int, seed: int = 42,
                n_clusters: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """The round-1 well-separated isotropic mixture (kept for comparison)."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(n_clusters, d)) * 6).astype(np.float32)
    base = np.empty((n, d), np.float32)
    chunk = 200_000
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        asg = rng.integers(0, n_clusters, e - s)
        base[s:e] = centers[asg] + \
            rng.normal(size=(e - s, d)).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, n_queries)] + \
        rng.normal(size=(n_queries, d)).astype(np.float32)
    return base, queries
