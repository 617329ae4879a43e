"""``torch.cuda.max_memory_allocated()`` over the program's set-up and
the window, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
