"""The benchmark's synthetic corpus: the LSH-hard mixture, drawn from a seed.

The distribution is the port's ``io/synthetic.lsh_hard_corpus`` (kept here
so that a change to the program's generator cannot move the yardstick):
rows near a rank-``d_eff`` manifold (x = z @ W plus ambient noise),
Zipf-sized clusters of lognormal radii whose centres lie ``separation``
mean radii apart, and fringe queries that offset a row by ``query_alpha``
times its cluster's radius in a random direction.

Two changes of procedure, none of distribution:

* The mixture itself (mixing matrix, cluster sizes, radii, centres) is
  drawn from the configuration's ``structure_seed``; the rows, queries and
  inserted rows from the run's ``--seed``.  Every seed so serves the same
  deployment (the same cluster sizes and geometry) with other rows, and
  runs on different seeds do the same amount of work.
* Each kind of draw has a stream of its own (base rows, queries, inserted
  rows, warm-up), so the base rows do not depend on how many queries or
  inserts a run draws, and the base rows are drawn on the card in a few
  large calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# one stream of random numbers per kind of draw
BASE, QUERIES, INSERTS, WARMUP, SAMPLE = range(5)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of run seed ``seed`` (any integer)."""
    ss = np.random.SeedSequence([seed % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def stream_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


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


@dataclass
class Mixture:
    """The deployment's data distribution (host float32 arrays)."""

    w_mix: np.ndarray      # [d_eff, d], orthonormal rows
    sizes: np.ndarray      # [clusters] rows per cluster in the base
    radii: np.ndarray      # [clusters]
    centers: np.ndarray    # [clusters, d_eff]
    ambient_noise: float
    query_alpha: float

    @property
    def d_eff(self) -> int:
        return self.w_mix.shape[0]

    @property
    def d(self) -> int:
        return self.w_mix.shape[1]


def mixture(spec: dict) -> Mixture:
    """The mixture of a configuration's ``corpus`` block, as
    ``lsh_hard_corpus`` draws it for ``n`` rows and its defaults."""
    n, d = spec["n"], spec["d"]
    rng = np.random.default_rng(spec["structure_seed"])
    d_eff = spec.get("d_eff") or max(8, d // 4)
    n_clusters = spec.get("n_clusters") or max(64, n // 1000)
    w_mix = rng.normal(size=(d_eff, d)).astype(np.float32)
    q_mat, _ = np.linalg.qr(w_mix.T)
    w_mix = np.ascontiguousarray(q_mat[:, :d_eff].T, dtype=np.float32)
    sizes = _zipf_sizes(rng, n_clusters, n, spec["zipf_a"])
    radii = np.exp(rng.normal(0.0, spec["radius_sigma"], n_clusters)
                   ).astype(np.float32)
    centers = rng.normal(size=(n_clusters, d_eff)).astype(np.float32)
    centers *= spec["separation"] * radii.mean() / np.sqrt(2.0)
    return Mixture(w_mix, sizes, radii, centers, spec["ambient_noise"],
                   spec["query_alpha"])


def base_rows(mix: Mixture, seed: int, device, chunk: int = 200_000
              ) -> tuple[np.ndarray, np.ndarray]:
    """(rows float32 [n, d], cluster int32 [n]) on the host: the base,
    drawn on ``device`` from ``seed``'s base stream in chunks of ``chunk``
    rows, each cluster holding exactly its ``sizes`` rows in random order."""
    n = int(mix.sizes.sum())
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, BASE))
    dev = torch.device(device)
    w = torch.from_numpy(mix.w_mix).to(dev)
    radii = torch.from_numpy(mix.radii).to(dev)
    centers = torch.from_numpy(mix.centers).to(dev)
    cluster = torch.repeat_interleave(
        torch.arange(len(mix.sizes), device=dev),
        torch.from_numpy(mix.sizes).to(dev))
    cluster = cluster[torch.randperm(n, generator=g, device=dev)]
    out = np.empty((n, mix.d), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c = cluster[s:e]
        z = centers[c] + torch.randn(e - s, mix.d_eff, generator=g,
                                     device=dev) * radii[c, None]
        x = z @ w + torch.randn(e - s, mix.d, generator=g,
                                device=dev) * mix.ambient_noise
        out[s:e] = x.cpu().numpy()
    return out, cluster.to(torch.int32).cpu().numpy()


def new_rows(mix: Mixture, rng: np.random.Generator, count: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """``count`` rows more from the same clusters, each cluster picked in
    proportion to its size: (rows float32, cluster int32)."""
    p = mix.sizes / mix.sizes.sum()
    c = rng.choice(len(p), size=count, p=p).astype(np.int32)
    z = mix.centers[c] + rng.normal(size=(count, mix.d_eff)).astype(
        np.float32) * mix.radii[c, None]
    x = z @ mix.w_mix + rng.normal(size=(count, mix.d)).astype(
        np.float32) * mix.ambient_noise
    return x.astype(np.float32), c


def fringe_queries(mix: Mixture, anchors: np.ndarray, cluster: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """Queries that offset each anchor row by ``query_alpha`` times its
    cluster's radius (scaled by sqrt(d_eff)) in a random direction."""
    delta = rng.normal(size=anchors.shape).astype(np.float32)
    delta /= np.linalg.norm(delta, axis=1, keepdims=True)
    offset = (mix.query_alpha * mix.radii[cluster]
              * np.sqrt(mix.d_eff)).astype(np.float32)
    return (anchors + delta * offset[:, None]).astype(np.float32)
