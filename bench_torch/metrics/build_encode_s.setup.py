"""Seconds the base's encode took in the run's ``index_stream``: the
``index.encode`` spans (one an ingest batch, host or device encode) under
the ``system.index_stream`` root.  Nothing where the program keeps no such
root or span."""

from bench_torch.program_spans import recent


def read(run):
    roots = recent("system.index_stream", 1)
    if not roots or "index.encode" not in roots[0]:
        return None
    return roots[0]["index.encode"] * 1e-9
