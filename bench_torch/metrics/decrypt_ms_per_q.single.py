"""Mean ``SearchStats.decrypt_ns`` per query (single requests): the host
AES-GCM open (and, on the host refine path, the fused scoring), in ms."""

from bench_torch.readers import mean_stat


def read(run):
    return mean_stat(run, "single", "decrypt_ns", 1e-6)
