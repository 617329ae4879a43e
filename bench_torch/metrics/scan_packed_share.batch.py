"""Share of the rows the scan scored (counter ``scan.rows``) that it scored
straight from packed code words (counter ``scan.packed_rows``), over the
window's ``search_batches`` calls (batched requests); nothing where the
program keeps no such counters."""

from bench_torch.program_spans import recent

ROWS, PACKED = "scan.rows", "scan.packed_rows"


def read(run):
    if run.kind != "batch" or not run.queries:
        return None
    mix = run.cell.traffic
    roots = recent("query.search_batches",
                   run.queries // (mix["batch"] * mix["calls"]))
    if not roots:
        return None
    rows = sum(r.get(ROWS, 0) for r in roots)
    return sum(r.get(PACKED, 0) for r in roots) / rows if rows else None
