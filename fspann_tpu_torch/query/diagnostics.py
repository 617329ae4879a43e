"""Per-query diagnostics: worst queries, zero hits, returned-vs-GT dumps.

Reference counterpart: ``api/QueryDiagnostics.java`` (:40-55) — maintains a
worst-queries heap by recall, tracks zero-hit queries, and writes a CSV of
returned vs ground-truth ids/distances for inspection
(query_diagnostics.csv, retrieved_samples.csv / retrieved_worst.csv,
reference ForwardSecureANNSystem.java:1463-1514).
"""

from __future__ import annotations

import csv
import heapq
from dataclasses import dataclass, field


@dataclass(order=True)
class _WorstEntry:
    recall: float
    query_index: int = field(compare=False)
    returned_ids: list = field(compare=False, default_factory=list)
    returned_dists: list = field(compare=False, default_factory=list)
    gt_ids: list = field(compare=False, default_factory=list)


class QueryDiagnostics:
    def __init__(self, worst_capacity: int = 20, sample_capacity: int = 20):
        self.worst_capacity = worst_capacity
        self.sample_capacity = sample_capacity
        self._worst: list[_WorstEntry] = []   # max-heap by -recall via neg
        self.samples: list[_WorstEntry] = []  # first N queries, in order
        self.zero_hit_queries: list[int] = []
        self.total = 0

    def record(self, query_index: int, recall: float, returned_ids,
               returned_dists, gt_ids) -> None:
        self.total += 1
        if recall == 0.0:
            self.zero_hit_queries.append(query_index)
        # cheap checks FIRST: the id/dist lists are only materialized when
        # the entry will actually be kept (capacities are ~20; list
        # construction per query was measurable on the eval loop)
        want_sample = len(self.samples) < self.sample_capacity
        worst_full = len(self._worst) >= self.worst_capacity
        # heap ordered by -recall: the root is the *best* (highest-recall)
        # of the kept set; a new query displaces it only if strictly worse
        want_worst = (not worst_full) or -recall > self._worst[0].recall
        if not (want_sample or want_worst):
            return
        entry = _WorstEntry(-recall, query_index,
                            [int(i) for i in returned_ids],
                            [float(d) for d in returned_dists],
                            [int(i) for i in gt_ids])
        if want_sample:
            self.samples.append(entry)
        if want_worst:
            if worst_full:
                heapq.heapreplace(self._worst, entry)
            else:
                heapq.heappush(self._worst, entry)

    def worst(self) -> list[_WorstEntry]:
        return sorted(self._worst, key=lambda e: -e.recall)

    @staticmethod
    def _write(path: str, entries) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["query_index", "recall", "returned_ids",
                        "returned_dists", "gt_ids"])
            for e in entries:
                w.writerow([e.query_index, -e.recall,
                            " ".join(map(str, e.returned_ids)),
                            " ".join(f"{d:.4f}" for d in e.returned_dists),
                            " ".join(map(str, e.gt_ids))])

    def export_csv(self, path: str) -> None:
        """Worst-queries dump (reference retrieved_worst.csv)."""
        self._write(path, self.worst())

    def export_samples_csv(self, path: str) -> None:
        """First-N-queries dump (reference retrieved_samples.csv)."""
        self._write(path, self.samples)

    def summary(self) -> dict:
        return {
            "total": self.total,
            "zero_hits": len(self.zero_hit_queries),
            "worst_recall": (-self._worst[0].recall if self._worst else None),
        }
