"""Mean ``SearchStats.upload_ns`` per query (batch requests, device
refine): the host-to-device copies of the refine's inputs, in ms."""

from bench_torch.program_spans import mean_field


def read(run):
    if run.program["runtime"].get("refine_backend") != "device":
        return None
    return mean_field(run, "batch", "upload_ns")
