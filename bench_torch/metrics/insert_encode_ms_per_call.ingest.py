"""Mean ``index.append.encode`` time per ``insert_live`` call of the window:
the new rows' LSH encode, in ms."""

from bench_torch.program_spans import insert_phase


def read(run):
    return insert_phase(run, "index.append.encode")
