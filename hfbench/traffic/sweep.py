"""Coefficient sweeps back to back, one client waiting for each: the
``sweep`` driver's batched grid and the fit's coarse grid.

Each unit is one ``run_sweep_time_chunked(problem, ks, fs, **recipe)`` of
``batch`` (kappa, fwhm) draws (the cell's set, in the seed's order), the
whole transient of every lane, traces back on the host. Set-up makes the chunk's module the sweep will
use and runs a ``warmup_steps``-step segment of the cell's batch through
the same kernels.

The fields that each time chunk returns (its last and next-to-last
step's) are kept for a few lanes of each unit, copied on the device as
the chunk returns and brought to the host after the sweep (``states``),
so that the comparison can hold those steps to the recipe's stopping
rule: ``resid_lanes`` lanes drawn from the seed, and the lanes of the
unit's extreme draws (the least and the largest kappa and FWHM).
"""

from __future__ import annotations

import numpy as np

from hfbench import draws


def setup(run) -> None:
    import torch
    from heatflow_tpu_torch.sim.sweepkernel import (balanced_chunk_len,
                                                    make_sweep_fn)
    recipe = run.recipe()
    chunk = recipe.pop("step_chunk")
    problem, B = run.problem, int(run.params["batch"])
    # the module the window's sweeps find in the problem's cache
    chunk_len = balanced_chunk_len(problem.num_steps, chunk)
    fn = make_sweep_fn(problem, num_steps=chunk_len, device=run.device,
                       **recipe)
    warm = make_sweep_fn(problem, num_steps=int(run.params["warmup_steps"]),
                         device=run.device, **recipe)
    d = run.draws(-B, B)
    u0 = torch.full((B,) + warm.shape, warm.ic_temp, dtype=recipe["dtype"],
                    device=run.device)
    warm.segment(d["kappa"], d["fwhm"], u0, 0)
    run.sync()
    run.entry = dict(recipe=recipe | {"step_chunk": chunk}, lanes=None,
                     ends=[])
    segment = fn.segment

    def kept(ks, fs, u0, step0, u_pp=None, iters_out=None):
        tr, u_fin, u_pen = segment(ks, fs, u0, step0, u_pp, iters_out)
        lanes = run.entry["lanes"]
        if lanes is not None:
            # advanced indexing copies: the lanes' fields, on the device
            run.entry["ends"].append((int(step0) + chunk_len,
                                      u_pen[lanes], u_fin[lanes]))
        return tr, u_fin, u_pen

    fn.segment = kept


def state_lanes(run, i: int, d: dict) -> np.ndarray:
    """The lanes of unit ``i`` whose chunk-end fields are kept."""
    B = len(d["kappa"])
    n = min(int(run.params.get("resid_lanes", 0)), B)
    picked = set(draws.rng(run.seed, 100 + i).choice(B, size=n,
                                                     replace=False).tolist())
    for v in (d["kappa"], d["fwhm"]):
        picked.update((int(np.argmin(v)), int(np.argmax(v))))
    return np.array(sorted(picked), dtype=np.int64)


def unit(run, i: int) -> dict:
    import torch
    from heatflow_tpu_torch.sim.sweepkernel import run_sweep_time_chunked
    B = int(run.params["batch"])
    d = run.draws(i * B, B)
    lanes = state_lanes(run, i, d)
    run.entry["lanes"] = torch.as_tensor(lanes, device=run.device)
    run.entry["ends"] = []
    its: list = []
    watch = run_sweep_time_chunked(run.problem, d["kappa"], d["fwhm"],
                                   device=run.device, iters_out=its,
                                   **run.entry["recipe"])
    ends = run.entry["ends"]
    run.entry["lanes"], run.entry["ends"] = None, []
    return dict(watch=watch, kappa=d["kappa"], fwhm=d["fwhm"],
                steps=run.problem.num_steps * B, configs=B,
                iters=np.stack([t.cpu().numpy() for t in its]),
                states=dict(lanes=lanes,
                            steps=np.array([s for s, _, _ in ends]),
                            before=np.stack([b.cpu().numpy()
                                             for _, b, _ in ends]),
                            after=np.stack([a.cpu().numpy()
                                            for _, _, a in ends])))
