"""The 95th percentile of every window run's time, from the call until
its answer is on the host (failed runs included), in ms."""
import numpy as np


def read(rec):
    if not rec.runs:
        return None
    return float(np.percentile([r.wall_s for r in rec.runs], 95)) * 1e3
