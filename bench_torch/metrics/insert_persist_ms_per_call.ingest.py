"""Mean ``store.persist`` time per ``insert_live`` call of the window: the
store's arena append and metadata put, with their fsyncs, in ms."""

from bench_torch.program_spans import insert_phase


def read(run):
    return insert_phase(run, "store.persist")
