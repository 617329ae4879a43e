"""Mean threads that took a share of a batch's candidate read (counter
``store.open.workers``, one count per read), per batch of the window's
``search_batches`` calls (batched requests); nothing where the program
keeps no such counter."""

from bench_torch.program_spans import recent, root_mean

COUNTER = "store.open.workers"


def read(run):
    if run.kind != "batch" or not run.queries:
        return None
    mix = run.cell.traffic
    calls = mix["calls"]
    roots = recent("query.search_batches",
                   run.queries // (mix["batch"] * calls))
    if not roots or not any(COUNTER in r for r in roots):
        return None
    return root_mean(roots, COUNTER, per=calls, scale=1.0)
