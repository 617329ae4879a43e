"""Share of the traced window in which nothing ran on the card (single
requests), in %."""

from bench_torch.readers import idle_share


def read(run):
    return idle_share(run, "single")
