"""Mean ``index.append.device`` time per ``insert_live`` call of the window:
the host's time to unpack, upload and place the new rows in the device scan
state (the copy itself is on the card), in ms."""

from bench_torch.program_spans import insert_phase


def read(run):
    return insert_phase(run, "index.append.device")
