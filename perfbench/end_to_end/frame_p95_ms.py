"""The 95th percentile, over every frame of the window, of the time from
the start of the step() call that takes the frame to the moment its boxes
are on the host (numpy's linear interpolation)."""
import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(run.latency_s), 95))
