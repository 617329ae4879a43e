"""Mean ciphertext MB opened a query (counter ``store.open.bytes``: each
record that reached an AES-GCM open, at its ciphertext length), per query
of the window's ``search_batches`` calls (batched requests); nothing where
the program keeps no such counter."""

from bench_torch.program_spans import recent, root_mean

COUNTER = "store.open.bytes"


def read(run):
    if run.kind != "batch" or not run.queries:
        return None
    mix = run.cell.traffic
    per_call = mix["batch"] * mix["calls"]
    roots = recent("query.search_batches", run.queries // per_call)
    if not roots or not any(COUNTER in r for r in roots):
        return None
    return root_mean(roots, COUNTER, per=per_call, scale=1e-6)
