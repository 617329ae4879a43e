"""Mean ``index.append.check`` time per ``insert_live`` call of the window: the
id and finiteness checks (``np.isin`` over every row id), in ms."""

from bench_torch.program_spans import insert_phase


def read(run):
    return insert_phase(run, "index.append.check")
