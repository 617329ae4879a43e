"""Mean ``SearchStats.track_ns`` per query (batch requests): the query
service's ``query.track`` span, which hands each batch's touched ids to the
re-encryption tracker, in ms."""

from bench_torch.readers import mean_stat


def read(run):
    return mean_stat(run, "batch", "track_ns", 1e-6)
