"""Single transients back to back, one client waiting for each: the
flagship run of ``run2d`` and of the fit's forward evaluations.

Each unit is one transient of ``make_simulate_fn(problem, **recipe)``
at the next (kappa, fwhm) draw, passed to the module's call; its outputs
come back to the host. Set-up makes the module and runs one transient
at the configuration's own coefficients (the graph capture, or the eager
loop's first pass).

Each unit also records, by solve form, the solves and the iterations the
device ran in the transient's graph, as the port's device-side counters
hold them (``forms``: {form: [solves, iterations launched]}; empty where
the transient runs no graph), and the transient's ADI solves
(``adi_solves``).
"""

from __future__ import annotations

import numpy as np

OUTPUTS = ("watch", "band", "axis")


def setup(run) -> None:
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    run.entry = make_simulate_fn(run.problem, device=run.device,
                                 **run.recipe())
    run.entry()
    run.sync()


def form_counts() -> dict:
    """{form: [solves, iterations launched]} that the device has counted
    in transients' graphs so far (``cuda_step.count_launches`` adds each
    launched transient's counts): solves from ``cg_tol``'s counter of the
    form, iterations from the loop bodies run (a body is ``CHECK_EVERY``
    iterations, those after the solve's stop returning at once)."""
    from heatflow_tpu_torch.ops import cuda_cg
    out = {}
    for form, (_, its) in cuda_cg._recorded_runs.items():
        base = form.removesuffix("_merged")
        counter = "launches_" + ("cheb" if base.startswith("cheb") else base)
        out[form] = [int(getattr(cuda_cg.cg_tol, counter, 0)), int(its)]
    return out


def unit(run, i: int) -> dict:
    d = run.draws(i, 1)
    problem = run.problem
    kappas = problem.kappas.copy()
    kappas[problem.mesh.material_tags[run.params["vary_material"]] - 1] = \
        d["kappa"][0]
    before = form_counts()
    ys = run.entry(kappas, None, float(d["fwhm"][0]))
    after = form_counts()
    forms = {f: [a - b for a, b in zip(n, before.get(f, [0, 0]))]
             for f, n in after.items()}
    forms = {f: n for f, n in forms.items() if n[0] or n[1]}
    rec = {k: ys[k].cpu().numpy()[None] for k in OUTPUTS if k in ys}
    rec.update(kappa=d["kappa"], fwhm=d["fwhm"], steps=problem.num_steps,
               configs=1, iters=ys["cg_iters"].cpu().numpy().reshape(-1, 1),
               forms=forms, adi_solves=np.array(
                   [sum(n[0] for f, n in forms.items()
                        if f.startswith("adi"))]))
    if "proj_iters" in ys:
        rec["proj_iters"] = ys["proj_iters"].cpu().numpy().reshape(-1, 1)
    return rec
