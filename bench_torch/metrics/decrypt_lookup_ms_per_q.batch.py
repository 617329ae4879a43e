"""Mean ``SearchStats.lookup_ns`` per query (batch requests): the store's
metadata lookup and per-key-version ordering and bounds, in ms."""

from bench_torch.program_spans import mean_field


def read(run):
    return mean_field(run, "batch", "lookup_ns")
