"""Mean candidates decrypted a query (``SearchStats.cand_decrypted``,
batched requests)."""

from bench_torch.readers import mean_stat


def read(run):
    return mean_stat(run, "batch", "cand_decrypted")
