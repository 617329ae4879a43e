"""Mean time per query (single requests) that the query service serves
outside every span: ``server_ns`` less route, decrypt, refine, token
open and tracking, in ms."""

from bench_torch.program_spans import unspanned


def read(run):
    return unspanned(run, "single")
