"""Mean ``SearchStats.decrypt_ns`` per query (batch requests): the host
AES-GCM open (and, on the host refine path, the fused scoring), in ms."""

from bench_torch.readers import mean_stat


def read(run):
    return mean_stat(run, "batch", "decrypt_ns", 1e-6)
