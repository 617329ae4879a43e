"""Mean ``SearchStats.track_ns`` per query (single requests): the query
service's ``query.track`` span, which hands each request's touched ids to
the re-encryption tracker, in ms."""

from bench_torch.readers import mean_stat


def read(run):
    return mean_stat(run, "single", "track_ns", 1e-6)
