"""A pool of host threads for work inside which numpy releases the
interpreter lock (the set-up's encode chunks and table sorts).  The caller
picks the width: ``store/parallel_read.default_width()`` where the work is
the process's own, 1 to stay on the caller's thread."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


def map_threads(fn, items, width: int) -> None:
    """``fn`` over ``items`` on a pool of ``width`` host threads; on the
    caller's thread alone when ``width`` is 1.  Every call's exception is
    raised here."""
    if width > 1:
        with ThreadPoolExecutor(width) as pool:
            list(pool.map(fn, items))
    else:
        for it in items:
            fn(it)
