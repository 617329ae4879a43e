"""Mean bytes the device scan state's growth writes on the card per
``insert_live`` call of the window (counter ``index.append.grow_bytes``),
in GiB."""

from bench_torch.program_spans import insert_phase


def read(run):
    return insert_phase(run, "index.append.grow_bytes", scale=2.0 ** -30)
