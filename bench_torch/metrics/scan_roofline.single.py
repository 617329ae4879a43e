"""Stage A of the scan route against its least time (single requests),
in % (bench_torch/roofline.scan_bound_s)."""

from bench_torch.readers import scan_roofline


def read(run):
    return scan_roofline(run, "single")
