"""Share of the touched ids that the query service forwarded to the
re-encryption tracker (counter ``query.track.fresh``) of those its touched
map examined (counter ``query.track.ids``), over the window's
``search_batches`` calls (batched requests); nothing where the program
keeps no such counters."""

from bench_torch.program_spans import recent

IDS, FRESH = "query.track.ids", "query.track.fresh"


def read(run):
    if run.kind != "batch" or not run.queries:
        return None
    mix = run.cell.traffic
    roots = recent("query.search_batches",
                   run.queries // (mix["batch"] * mix["calls"]))
    if not roots:
        return None
    ids = sum(r.get(IDS, 0) for r in roots)
    return sum(r.get(FRESH, 0) for r in roots) / ids if ids else None
