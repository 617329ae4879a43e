"""Mean ``SearchStats.dispatch_ns`` per query (batch requests): the host's
time in ``route_batch``, stage A's dispatch without the wait, in ms."""

from bench_torch.program_spans import mean_field


def read(run):
    return mean_field(run, "batch", "dispatch_ns")
