"""Mean bytes the host code array and row ids' regrowth copies per
``insert_live`` call of the window (counter
``index.append.host_grow_bytes``: 0 on a call that writes into spare rows),
in MiB.  Nothing where the program keeps no such counter."""

from bench_torch.program_spans import insert_phase, recent

COUNTER = "index.append.host_grow_bytes"


def read(run):
    roots = recent("system.insert_live", len(run.insert_ms)) \
        if run.insert_ms else None
    if not roots or not any(COUNTER in r for r in roots):
        return None
    return insert_phase(run, COUNTER, scale=2.0 ** -20)
