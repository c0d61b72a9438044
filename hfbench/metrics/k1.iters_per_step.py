"""K1's iterations a time step over the traced transients: the run's own
``cg_iters`` (the inner float32 solve's count, summed over refinement
passes)."""

import numpy as np


def read(run):
    its = [u["iters"].sum(axis=1) for u in run.units]
    return float(np.concatenate(its).mean()) if its else None
