"""The one traffic generator: reads a mix's parameters from
``traffic/<mix>.json`` and yields the cycles of a closed loop.

A cycle is what one client does before it looks at the clock again:

* ``insert_rows`` > 0: one ``insert_live`` of that many new rows (ids after
  every row so far, from the same clusters), acknowledged before the
  cycle's queries are made;
* then ``calls`` requests of ``batch`` distinct queries at ``top_k``:
  with ``"requests": "batch"`` the cycle's batches go to the query service
  in one ``search_batches`` call; with ``"requests": "single"`` each query
  is its own request (``batch`` is then 1).

Each query offsets an anchor row (``corpus.fringe_queries``).  Anchors are
``"uniform"`` over every live row, or ``"latest"``: YCSB's skewed-latest
generator, Zipf(``zipf_theta``) over recency rank, rank 0 the newest row.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import corpus

KEYS = {"requests", "batch", "calls", "top_k", "insert_rows", "anchors",
        "zipf_theta", "why"}


def load(root: str, name: str) -> dict:
    path = os.path.join(root, "bench_torch", "traffic", f"{name}.json")
    with open(path) as f:
        spec = json.load(f)
    unknown = set(spec) - KEYS
    if unknown:
        raise ValueError(f"{path}: unknown keys {sorted(unknown)}")
    if spec["requests"] not in ("batch", "single"):
        raise ValueError(f"{path}: requests must be batch or single")
    if spec["requests"] == "single" and spec["batch"] != 1:
        raise ValueError(f"{path}: a single request holds one query")
    if spec.get("anchors", "uniform") not in ("uniform", "latest"):
        raise ValueError(f"{path}: anchors must be uniform or latest")
    return spec


class LatestGenerator:
    """YCSB's ``SkewedLatestGenerator`` (Zipfian over recency, its
    ``ZipfianGenerator`` by Gray et al.'s method) over a growing item count.
    :meth:`sample` returns item indices; index ``n - 1`` is the newest."""

    def __init__(self, n: int, theta: float):
        self.theta = theta
        self.alpha = 1.0 / (1.0 - theta)
        self.zeta2 = 1.0 + 0.5 ** theta
        self.n = 0
        self.zetan = 0.0
        self.grow(n)

    def grow(self, n: int) -> None:
        """Extend the item count to ``n``: zeta(n) = sum of i^-theta."""
        if n > self.n:
            i = np.arange(self.n + 1, n + 1, dtype=np.float64)
            self.zetan += float(np.sum(i ** -self.theta))
            self.n = n

    def ranks(self, u: np.ndarray) -> np.ndarray:
        """Recency ranks (0 = newest) for uniform draws ``u`` in [0, 1)."""
        n, th = self.n, self.theta
        eta = (1.0 - (2.0 / n) ** (1.0 - th)) / (1.0 - self.zeta2 / self.zetan)
        uz = u * self.zetan
        r = np.floor(n * (eta * u - eta + 1.0) ** self.alpha).astype(np.int64)
        r = np.where(uz < 1.0 + 0.5 ** th, 1, r)
        r = np.where(uz < 1.0, 0, r)
        return np.minimum(r, n - 1)

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return (self.n - 1) - self.ranks(rng.random(size))


class Rows:
    """Every row the program holds, in id order: the base, then the rows
    inserted (host float32, with each row's cluster)."""

    def __init__(self, base: np.ndarray, cluster: np.ndarray):
        self.base, self.base_cluster = base, cluster
        self._extra: list[np.ndarray] = []
        self._extra_cluster: list[np.ndarray] = []
        self._extra_cat = None

    def __len__(self) -> int:
        return len(self.base) + sum(len(x) for x in self._extra)

    def append(self, rows: np.ndarray, cluster: np.ndarray) -> None:
        self._extra.append(rows)
        self._extra_cluster.append(cluster)
        self._extra_cat = None

    def extra(self) -> tuple[np.ndarray, np.ndarray]:
        if self._extra_cat is None:
            d = self.base.shape[1]
            self._extra_cat = (
                np.concatenate(self._extra) if self._extra
                else np.zeros((0, d), np.float32),
                np.concatenate(self._extra_cluster) if self._extra
                else np.zeros(0, np.int32))
        return self._extra_cat

    def take(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(rows, clusters) of ``ids``."""
        n0 = len(self.base)
        old = ids < n0
        if old.all():
            return self.base[ids], self.base_cluster[ids]
        er, ec = self.extra()
        rows = np.where(old[:, None], self.base[np.minimum(ids, n0 - 1)],
                        er[np.maximum(ids - n0, 0)])
        cl = np.where(old, self.base_cluster[np.minimum(ids, n0 - 1)],
                      ec[np.maximum(ids - n0, 0)])
        return rows.astype(np.float32), cl

    def all(self) -> np.ndarray:
        er, _ = self.extra()
        return np.concatenate([self.base, er]) if len(er) else self.base


class Generator:
    """The cycles of one run: the same seed gives the same rows and
    queries, whatever the window's length."""

    def __init__(self, spec: dict, mix: corpus.Mixture, rows: Rows,
                 seed: int):
        self.spec, self.mix, self.rows = spec, mix, rows
        self.q_rng = corpus.stream_rng(seed, corpus.QUERIES)
        self.i_rng = corpus.stream_rng(seed, corpus.INSERTS)
        self.w_rng = corpus.stream_rng(seed, corpus.WARMUP)
        self.latest = LatestGenerator(len(rows), spec["zipf_theta"]) \
            if spec.get("anchors") == "latest" else None

    @property
    def per_cycle(self) -> int:
        return self.spec["batch"] * self.spec["calls"]

    def insert(self) -> tuple[np.ndarray, np.ndarray] | None:
        """(ids, rows) of the next insert, added to ``rows``, or None."""
        count = self.spec.get("insert_rows", 0)
        if not count:
            return None
        x, c = corpus.new_rows(self.mix, self.i_rng, count)
        first = len(self.rows)
        self.rows.append(x, c)
        if self.latest is not None:
            self.latest.grow(len(self.rows))
        return np.arange(first, first + count, dtype=np.int64), x

    def queries(self, count: int, warmup: bool = False) -> np.ndarray:
        """``count`` fresh queries over the rows live now."""
        rng = self.w_rng if warmup else self.q_rng
        n = len(self.rows)
        if self.latest is not None:
            ids = self.latest.sample(rng, count)
        else:
            ids = rng.integers(0, n, count)
        anchors, cluster = self.rows.take(ids)
        return corpus.fringe_queries(self.mix, anchors, cluster, rng)
