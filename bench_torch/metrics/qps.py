"""Queries answered in the window over the window's wall time (tokens
made inside it)."""


def read(run):
    return run.queries / run.window_s if run.queries else None
