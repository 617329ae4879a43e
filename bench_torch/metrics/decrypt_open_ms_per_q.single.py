"""Mean ``SearchStats.open_ns`` per query (single requests): the store's
C AES-GCM open (and fused score) alone, in ms."""

from bench_torch.program_spans import mean_field


def read(run):
    return mean_field(run, "single", "open_ns")
