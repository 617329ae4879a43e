"""Rows acknowledged by ``insert_live`` over the window's wall time."""


def read(run):
    return run.inserted_rows / run.window_s if run.inserted_rows else None
