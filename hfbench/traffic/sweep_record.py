"""Gradient-recording sweeps back to back, one client waiting for each:
``sweep --record-gradient``, whose rows feed the 1D reduced model.

Each unit is one call of ``make_sweep_fn_recording(problem, **recipe)`` on
``batch`` (kappa, fwhm) draws (the cell's set, in the seed's order):
watcher traces and the band and axis rows of every lane, back on the host. Set-up makes the module and runs one
sweep of the cell's batch (the maker has no shorter segment).
"""

from __future__ import annotations

import numpy as np

OUTPUTS = ("watch", "band", "axis")


def setup(run) -> None:
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn_recording
    run.entry = make_sweep_fn_recording(run.problem, device=run.device,
                                        **run.recipe())
    B = int(run.params["batch"])
    d = run.draws(-B, B)
    run.entry(d["kappa"], d["fwhm"])
    run.sync()


def unit(run, i: int) -> dict:
    B = int(run.params["batch"])
    d = run.draws(i * B, B)
    its: list = []
    pits: list = []
    out = run.entry(d["kappa"], d["fwhm"], iters_out=its,
                    proj_iters_out=pits)
    rec = {k: out[k].cpu().numpy() for k in OUTPUTS}
    rec.update(kappa=d["kappa"], fwhm=d["fwhm"],
               steps=run.problem.num_steps * B, configs=B,
               iters=np.stack([t.cpu().numpy() for t in its]),
               proj_iters=np.stack([t.cpu().numpy() for t in pits]))
    return rec
