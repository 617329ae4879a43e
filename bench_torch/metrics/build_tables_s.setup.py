"""Seconds the partition tables took in the run's ``finalize_for_search``:
the ``index.finalize.tables`` span (the G groups' sorts and the table's
copy to the card) under the ``system.finalize`` root.  Nothing where the
program keeps no such root or span."""

from bench_torch.program_spans import recent


def read(run):
    roots = recent("system.finalize", 1)
    if not roots or "index.finalize.tables" not in roots[0]:
        return None
    return roots[0]["index.finalize.tables"] * 1e-9
