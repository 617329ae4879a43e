"""95th percentile of every query's latency in the window, from the
moment the client starts its token to the results on the host (numpy's
linear interpolation)."""

import numpy as np


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(run.latencies_ms, 95))
