"""Mean ``index.append.host_copy`` time per ``insert_live`` call of the window:
the ``np.concatenate`` of the host code array and row ids, in ms."""

from bench_torch.program_spans import insert_phase


def read(run):
    return insert_phase(run, "index.append.host_copy")
