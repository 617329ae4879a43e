"""Reduce per-query rows into the paper's evaluation summary.

Reference counterparts: ``query/core/Aggregates.java`` (:50-147 — mean ART,
ratio@K map, recall@K map, candidate pipeline means; headline = ratio@100 +
recall@10 :124-127) and ``query/core/EvaluationSummaryPrinter.java``
(summary.csv / accuracy.csv / cost.csv writers, standard K set :13).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.profiler import QueryRow

STANDARD_KS = (1, 10, 20, 40, 60, 80, 100)


@dataclass
class Aggregates:
    num_queries: int = 0
    mean_art_ms: float = 0.0
    p50_art_ms: float = 0.0
    p95_art_ms: float = 0.0
    p99_art_ms: float = 0.0
    p999_art_ms: float = 0.0
    recall_at_k: dict[int, float] = field(default_factory=dict)
    ratio_at_k: dict[int, float] = field(default_factory=dict)
    candidate_ratio_at_k: dict[int, float] = field(default_factory=dict)
    mean_cand_unique: float = 0.0
    mean_cand_decrypted: float = 0.0
    mean_returned: float = 0.0
    retry_fraction: float = 0.0

    @property
    def headline(self) -> tuple[float, float]:
        """(ratio@maxK, recall@10) — reference Aggregates.java:124-127."""
        max_k = max(self.ratio_at_k) if self.ratio_at_k else 0
        return (self.ratio_at_k.get(max_k, float("nan")),
                self.recall_at_k.get(10, float("nan")))

    @classmethod
    def from_rows(cls, rows: list[QueryRow]) -> "Aggregates":
        if not rows:
            return cls()
        by_k: dict[int, list[QueryRow]] = {}
        per_query: dict[int, QueryRow] = {}
        for r in rows:
            by_k.setdefault(r.k, []).append(r)
            per_query[r.query_index] = r
        qrows = list(per_query.values())
        n = len(qrows)
        agg = cls(num_queries=n)
        agg.mean_art_ms = sum(r.server_ms for r in qrows) / n
        lat = sorted(r.server_ms for r in qrows)
        agg.p50_art_ms = lat[n // 2]
        agg.p95_art_ms = lat[min(n - 1, int(0.95 * (n - 1)))]
        agg.p99_art_ms = lat[min(n - 1, int(0.99 * (n - 1)))]
        agg.p999_art_ms = lat[min(n - 1, int(0.999 * (n - 1)))]
        for k, rs in by_k.items():
            agg.recall_at_k[k] = sum(r.recall_at_k for r in rs) / len(rs)
            ratios = [r.distance_ratio_at_k for r in rs
                      if r.distance_ratio_at_k == r.distance_ratio_at_k]
            agg.ratio_at_k[k] = (sum(ratios) / len(ratios)) if ratios \
                else float("nan")
            agg.candidate_ratio_at_k[k] = \
                sum(r.candidate_ratio_at_k for r in rs) / len(rs)
        agg.mean_cand_unique = sum(r.cand_unique for r in qrows) / n
        agg.mean_cand_decrypted = sum(r.cand_decrypted for r in qrows) / n
        agg.mean_returned = sum(r.returned for r in qrows) / n
        agg.retry_fraction = sum(1 for r in qrows if r.retried) / n
        return agg

    @classmethod
    def from_profiler(cls, profiler,
                      since: tuple[int, int] | None = None) -> "Aggregates":
        """Vectorized aggregation straight from the profiler's column
        blocks — no per-row object materialization (the per-object path
        cost ~1 ms/query ×7 K-variants at serving rates).  ``since``: a
        ``profiler.mark()`` taken at run start — aggregate only rows this
        run recorded (sweeps mutate config between runs on one system)."""
        cols = profiler.columns(since)
        if cols is None:
            return cls()
        return cls.from_columns(cols)

    @classmethod
    def from_columns(cls, c: dict[str, np.ndarray]) -> "Aggregates":
        k_col = np.asarray(c["k"])
        qi = np.asarray(c["query_index"])
        # per-query stats are identical across a query's K rows; pick one K
        # and keep each query's LAST row (matches from_rows' last-wins)
        sel = np.flatnonzero(k_col == k_col.min())
        q_ids = qi[sel]
        _, last_rev = np.unique(q_ids[::-1], return_index=True)
        keep = sel[len(q_ids) - 1 - last_rev]
        n = len(keep)
        server = np.asarray(c["server_ms"], np.float64)[keep]
        agg = cls(num_queries=n)
        agg.mean_art_ms = float(server.mean())
        lat = np.sort(server)
        agg.p50_art_ms = float(lat[n // 2])
        agg.p95_art_ms = float(lat[min(n - 1, int(0.95 * (n - 1)))])
        agg.p99_art_ms = float(lat[min(n - 1, int(0.99 * (n - 1)))])
        agg.p999_art_ms = float(lat[min(n - 1, int(0.999 * (n - 1)))])
        recall = np.asarray(c["recall_at_k"], np.float64)
        ratio = np.asarray(c["distance_ratio_at_k"], np.float64)
        cand_ratio = np.asarray(c["candidate_ratio_at_k"], np.float64)
        for k in np.unique(k_col):
            m = k_col == k
            agg.recall_at_k[int(k)] = float(recall[m].mean())
            r = ratio[m]
            r = r[~np.isnan(r)]
            agg.ratio_at_k[int(k)] = float(r.mean()) if len(r) \
                else float("nan")
            agg.candidate_ratio_at_k[int(k)] = float(cand_ratio[m].mean())
        agg.mean_cand_unique = float(
            np.asarray(c["cand_unique"], np.float64)[keep].mean())
        agg.mean_cand_decrypted = float(
            np.asarray(c["cand_decrypted"], np.float64)[keep].mean())
        agg.mean_returned = float(
            np.asarray(c["returned"], np.float64)[keep].mean())
        agg.retry_fraction = float(
            np.asarray(c["retried"], np.float64)[keep].mean())
        return agg

    def paper_line(self) -> str:
        ratio, recall10 = self.headline
        return (f"queries={self.num_queries} ART={self.mean_art_ms:.1f}ms "
                f"ratio={ratio:.4f} recall@10={recall10:.4f} "
                f"cands={self.mean_cand_unique:.0f} "
                f"decrypted={self.mean_cand_decrypted:.0f} "
                f"retries={self.retry_fraction:.2%}")


def write_csvs(agg: Aggregates, out_dir: str) -> None:
    """summary.csv / accuracy.csv / cost.csv
    (reference EvaluationSummaryPrinter.java:64-76)."""
    os.makedirs(out_dir, exist_ok=True)
    ks = sorted(agg.recall_at_k)
    with open(os.path.join(out_dir, "summary.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["num_queries", "mean_art_ms", "mean_cand_unique",
                    "mean_cand_decrypted", "mean_returned", "retry_fraction"])
        w.writerow([agg.num_queries, f"{agg.mean_art_ms:.3f}",
                    f"{agg.mean_cand_unique:.1f}",
                    f"{agg.mean_cand_decrypted:.1f}",
                    f"{agg.mean_returned:.1f}", f"{agg.retry_fraction:.4f}"])
    with open(os.path.join(out_dir, "accuracy.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["k", "recall_at_k", "distance_ratio_at_k",
                    "candidate_ratio_at_k"])
        for k in ks:
            w.writerow([k, f"{agg.recall_at_k[k]:.6f}",
                        f"{agg.ratio_at_k[k]:.6f}",
                        f"{agg.candidate_ratio_at_k[k]:.6f}"])
    with open(os.path.join(out_dir, "cost.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "value"])
        w.writerow(["mean_art_ms", f"{agg.mean_art_ms:.3f}"])
        w.writerow(["mean_cand_decrypted", f"{agg.mean_cand_decrypted:.1f}"])
