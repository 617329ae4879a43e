"""Mean host threads that took rows of one host encode call of more than
one chunk (an ingest batch) in the run's ``index_stream``: counter
``index.encode.workers`` over ``index.encode.calls`` under the
``system.index_stream`` root.  Nothing where the encode ran on the card or
the program keeps no such counters."""

from bench_torch.program_spans import recent


def read(run):
    roots = recent("system.index_stream", 1)
    if not roots or not roots[0].get("index.encode.calls"):
        return None
    return roots[0].get("index.encode.workers", 0) \
        / roots[0]["index.encode.calls"]
