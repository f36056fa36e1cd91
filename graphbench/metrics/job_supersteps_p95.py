"""95th percentile of the supersteps a job of the window was pushed in."""

import numpy as np


def read(rec):
    xs = rec["job_supersteps"]
    return float(np.percentile(xs, 95)) if xs else None
