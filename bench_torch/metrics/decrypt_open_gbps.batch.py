"""Ciphertext GB opened a second of the store's native open pass: counter
``store.open.bytes`` over span ``store.open``, both summed over the
window's ``search_batches`` calls (batched requests); nothing where the
program keeps no such counter."""

from bench_torch.program_spans import recent

COUNTER, SPAN = "store.open.bytes", "store.open"


def read(run):
    if run.kind != "batch" or not run.queries:
        return None
    mix = run.cell.traffic
    roots = recent("query.search_batches",
                   run.queries // (mix["batch"] * mix["calls"]))
    if not roots or not any(COUNTER in r for r in roots):
        return None
    open_ns = sum(r.get(SPAN, 0) for r in roots)
    if open_ns <= 0:
        return None
    # bytes a nanosecond are GB a second
    return sum(r.get(COUNTER, 0) for r in roots) / open_ns
