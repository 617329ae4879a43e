"""What the readers of the program's own spans share
(``fspann_tpu_torch/utils/profiler.py``): means of the per-query
``SearchStats`` fields the query service fills from its spans, and means
over the window's last requests of one kind, as the span recorder keeps
them.  A program without the recorder or the fields reads as nothing."""

from __future__ import annotations

import numpy as np

# the per-query parts of server_ns that a span covers
SPANNED = ("route_ns", "decrypt_ns", "refine_ns", "token_open_ns",
           "track_ns")


def mean_field(run, kind: str, field: str, scale: float = 1e-6):
    """Mean of a ``SearchStats`` field, times ``scale``, over the window's
    queries that carry it, in a cell whose requests are ``kind``."""
    if run.kind != kind:
        return None
    vals = [v for v in (getattr(s, field, None) for s in run.stats)
            if v is not None]
    return float(np.mean(vals)) * scale if vals else None


def unspanned(run, kind: str, scale: float = 1e-6):
    """Mean ``server_ns`` less the parts that spans cover, per query."""
    if run.kind != kind or not run.stats \
            or not all(hasattr(run.stats[0], f) for f in SPANNED):
        return None
    return float(np.mean([s.server_ns - sum(getattr(s, f) for f in SPANNED)
                          for s in run.stats])) * scale


def recent(root: str, n: int) -> list | None:
    """The program's last ``n`` requests named ``root``, or None where the
    program keeps no such record or fewer than ``n`` of them."""
    try:
        from fspann_tpu_torch.utils import profiler
        roots = profiler.recent(root, n)
    except (ImportError, AttributeError):
        return None
    return roots if n > 0 and len(roots) == n else None


def root_mean(roots: list | None, name: str, per: float = 1.0,
              scale: float = 1e-6):
    """Mean of ``name``'s total in each root, over ``per``, times
    ``scale``."""
    if not roots:
        return None
    return float(np.mean([r.get(name, 0) for r in roots])) / per * scale


def token_ms_per_q(run, kind: str):
    """Mean ``token.create`` time per query over the window's token
    batches (one a request in single-query cells)."""
    if run.kind != kind or not run.queries:
        return None
    batch = run.cell.traffic["batch"]
    return root_mean(recent("token.create", run.queries // batch),
                     "token.create", per=batch)


def insert_phase(run, name: str, scale: float = 1e-6):
    """Mean total of ``name`` per ``insert_live`` call of the window."""
    if not run.insert_ms:
        return None
    return root_mean(recent("system.insert_live", len(run.insert_ms)), name,
                     scale=scale)
