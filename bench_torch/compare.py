"""The comparison that decides ``correct``: what the window served against
the plain reference, number by number, each beside its limit.

* ``failed``: requests of the window that were answered wrongly in form
  (fewer than ``top_k`` results, an id twice, an id not live when the query
  was issued, distances out of order or not finite).  Exact: limit 0.
* ``dist_err``: the widest relative gap between a served distance and the
  reference's distance of the same id to the same query (the decrypt and
  the refine's arithmetic).
* ``recall10``: the mean share of the reference's top 10 that the served
  top 10 holds (the route), at least the configuration's stated recall.
* ``ratio100``: the mean over queries of the mean of max(reference distance
  of the i-th served id / i-th exact distance, 1) over the top 100, at
  most the configuration's stated ratio.
* ``recall10_new``, where the traffic inserts: the share of the reference
  top-10 entries that are rows inserted after set-up which the served top
  10 holds: every acknowledged row is found like any other.
"""

from __future__ import annotations

import numpy as np


def malformed(ids: np.ndarray, dists: np.ndarray, live: np.ndarray,
              k: int) -> np.ndarray:
    """bool [Q]: the answer is not ``k`` distinct live ids in ascending
    order of finite distance."""
    ok = (ids >= 0) & np.isfinite(dists)
    bad = ok.sum(1) < k
    bad |= (ids >= live[:, None]).any(1)
    srt = np.sort(np.where(ok, ids, -1 - np.arange(ids.shape[1])), axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    d = np.where(ok, dists, np.inf)
    bad |= (d[:, 1:] < d[:, :-1]).any(1)
    return bad


def numbers(served_ids: np.ndarray, served_d: np.ndarray,
            served_ref_d: np.ndarray, ref_ids: np.ndarray,
            ref_d: np.ndarray, new_from: int | None) -> dict:
    """The compared numbers over the sampled queries.  ``served_ref_d`` is
    the reference's distance of each served id (nan where none)."""
    valid = served_ids >= 0
    rel = np.abs(served_d.astype(np.float64) - served_ref_d) \
        / np.maximum(served_ref_d, 1e-30)
    rel = np.where(valid & np.isfinite(served_ref_d), rel, 0.0)
    k10 = min(10, ref_ids.shape[1])
    hit10 = (ref_ids[:, :k10, None] == np.where(
        valid[:, :k10], served_ids[:, :k10], -2)[:, None, :]).any(2)
    hit10 &= ref_ids[:, :k10] >= 0
    n_ref10 = np.maximum((ref_ids[:, :k10] >= 0).sum(1), 1)
    out = {"dist_err": float(rel.max(initial=0.0)),
           "recall10": float((hit10.sum(1) / n_ref10).mean())}
    k = ref_ids.shape[1]
    ok = valid[:, :k] & np.isfinite(served_ref_d[:, :k]) \
        & np.isfinite(ref_d) & (ref_d > 0)
    ratio = np.where(ok, np.maximum(served_ref_d[:, :k]
                                    / np.where(ok, ref_d, 1.0), 1.0), 0.0)
    out["ratio100"] = float((ratio.sum(1) / np.maximum(ok.sum(1), 1)).mean())
    if new_from is not None:
        new = (ref_ids[:, :k10] >= new_from)
        out["recall10_new"] = float(hit10[new].mean()) if new.any() \
            else float("nan")
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit", "pass"}}).  A limit is
    ``{"max": x}`` or ``{"min": x}``; a number that is nan (nothing to
    compare) fails."""
    out, correct = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        if v is None:
            continue
        if "max" in lim:
            ok = bool(v <= lim["max"])
            bound = f"<= {lim['max']}"
        else:
            ok = bool(v >= lim["min"])
            bound = f">= {lim['min']}"
        correct &= ok
        out[name] = {"value": v, "limit": bound, "pass": ok}
    return correct, out
