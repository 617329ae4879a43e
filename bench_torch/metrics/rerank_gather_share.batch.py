"""Share of the candidate slots the probe route's full-code re-rank scored
(counter ``code_hamming.slots``) that a gather scored, the kernel's gather
path or the plain version (counter ``code_hamming.gather_slots``), over the
window's ``search_batches`` calls (batched requests); nothing where the
program keeps no such counters."""

from bench_torch.program_spans import recent

SLOTS, GATHER = "code_hamming.slots", "code_hamming.gather_slots"


def read(run):
    if run.kind != "batch" or not run.queries:
        return None
    mix = run.cell.traffic
    roots = recent("query.search_batches",
                   run.queries // (mix["batch"] * mix["calls"]))
    if not roots:
        return None
    slots = sum(r.get(SLOTS, 0) for r in roots)
    return sum(r.get(GATHER, 0) for r in roots) / slots if slots else None
