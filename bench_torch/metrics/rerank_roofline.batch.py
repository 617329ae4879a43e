"""The probe route's ``code_hamming`` re-rank against its least bytes, in
% (bench_torch/roofline.hamming_bound)."""

from bench_torch.readers import rerank_roofline


def read(run):
    return rerank_roofline(run) if run.kind == "batch" else None
