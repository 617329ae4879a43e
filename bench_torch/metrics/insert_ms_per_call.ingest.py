"""Mean wall time of one ``insert_live`` call in the window, in ms."""


def read(run):
    if not run.insert_ms:
        return None
    return sum(run.insert_ms) / len(run.insert_ms)
