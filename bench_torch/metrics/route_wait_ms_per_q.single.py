"""Mean ``SearchStats.route_ns`` per query (single requests): stage A's
dispatch plus the host's wait on the device, in ms."""

from bench_torch.readers import mean_stat


def read(run):
    return mean_stat(run, "single", "route_ns", 1e-6)
