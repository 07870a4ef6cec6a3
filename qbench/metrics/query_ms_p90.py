"""The 90th percentile of the latencies of every query completed in the
window (host clock, submission to the synchronize after its Table is
returned; linear between order statistics)."""

import numpy as np


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms), 90))
