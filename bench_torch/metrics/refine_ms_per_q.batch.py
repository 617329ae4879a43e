"""Mean ``SearchStats.refine_ns`` per query (batched requests): stage C,
on the host or the card, in ms."""

from bench_torch.readers import mean_stat


def read(run):
    return mean_stat(run, "batch", "refine_ns", 1e-6)
