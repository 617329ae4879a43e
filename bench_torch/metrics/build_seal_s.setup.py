"""Seconds the store's AES-GCM seal of the base took in the run's
``index_stream``: the ``store.seal`` spans (one an ingest batch) under the
``system.index_stream`` root.  Nothing where the program keeps no such
root."""

from bench_torch.program_spans import recent


def read(run):
    roots = recent("system.index_stream", 1)
    if not roots or "store.seal" not in roots[0]:
        return None
    return roots[0]["store.seal"] * 1e-9
