"""Mean ``SearchStats.stage_a_device_ns`` per query (single requests):
stage A on the card between two CUDA events around ``route_batch``,
bubbles included, over the traced part of the window, in ms."""

from bench_torch.program_spans import mean_field


def read(run):
    return mean_field(run, "single", "stage_a_device_ns")
