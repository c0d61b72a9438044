"""The 90th percentile of one transient's wall time, from its call to the
synchronize that ends it, over every transient of the window."""

import numpy as np


def read(run):
    times = [u["t1"] - u["t0"] for u in run.units]
    return float(np.percentile(times, 90)) * 1e3
