"""What decides ``correct``: the answers of the run against the plain
reference, after the window, with the program's state freed.

Every answer due in the window is looked at: a lane (one transient, or
one configuration of a sweep) whose outputs are not all finite, or whose
watchers never move by ``RISE_K`` over the transient, never came
(``unanswered``). A sample of the answers is run again by the reference
(``hfbench/reference/fem.py``, float64) from the same coefficients
(``gaps``): ``check_samples`` drawn from the seed, and for each record key
that ``check_hardest`` names, the lane whose values of it sum highest
(the transient with the most ADI solves, the sweep lane with the most
iterations). The reference runs on the mesh the configuration file names:
the structured grid, or the same graded triangulation as the program's,
built by the reference's own frozen copy. Where a unit kept fields at the
ends of time steps (``states``), each of those steps is held to the
recipe's stopping rule (``step_resid``: the reference's ||r|| / ||b|| of
the step's system). The numbers that the cell's workload file gives a
limit (``limits``) are compared, each limit set from the readings that
``PERF.md`` gives; the others are printed beside them.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from hfbench import draws
from hfbench.reference.fem import Reference

RISE_K = 1.0


def unanswered(rec: dict) -> int:
    """Lanes of a unit whose outputs are not finite, or whose watchers
    all stay within RISE_K of one value over every step (lanes, steps,
    watchers)."""
    keys = [k for k in ("watch", "band", "axis") if k in rec]
    bad = np.zeros(rec["watch"].shape[0], dtype=bool)
    for k in keys:
        bad |= ~np.isfinite(rec[k]).reshape(len(bad), -1).all(axis=1)
    w = np.nan_to_num(rec["watch"])
    bad |= (w.max(axis=1) - w.min(axis=1)).max(axis=1) <= RISE_K
    return int(bad.sum())


def gaps(got: dict, want: dict, ic: float) -> dict:
    """The readings of one answer against the reference's (a gap that is
    not a number, or between rows of different shapes, as from another
    mesh, reads as infinite): the watchers' widest gap, and the widest gap
    of their step increments (the first from the initial temperature
    ``ic``), in kelvin; the gradient rows' widest gap over the reference's
    largest magnitude."""
    widest = lambda a, b: float(np.nan_to_num(np.abs(a - b).max(),
                                              nan=np.inf)) \
        if np.shape(a) == np.shape(b) else math.inf
    steps = lambda w: np.diff(w, axis=0, prepend=np.full((1,) + w.shape[1:],
                                                         ic))
    out = {"watch_gap_K": widest(got["watch"], want["watch"]),
           "watch_step_gap_K": widest(steps(got["watch"]),
                                      steps(want["watch"]))}
    for k in ("band", "axis"):
        if k in got and k in want and want[k].size:
            out[f"{k}_gap_rel"] = widest(got[k], want[k]) \
                / float(np.abs(want[k]).max())
    return out


def sample(run, n: int, hardest=()) -> list[tuple[int, int]]:
    """(unit, lane) pairs of the window's answers: ``n`` drawn from the
    seed without repeats, then for each record key in ``hardest`` the lane
    whose values of it sum highest (the first such lane on a tie)."""
    lanes = [(u, j) for u, rec in enumerate(run.units)
             for j in range(rec["watch"].shape[0])]
    pick = draws.rng(run.seed, 1).choice(len(lanes), size=min(n, len(lanes)),
                                         replace=False)
    out = [lanes[i] for i in sorted(pick)]
    for key in hardest:
        score = [np.asarray(run.units[u][key]).reshape(-1, len(
            run.units[u]["kappa"]))[:, j].sum() for u, j in lanes]
        best = lanes[int(np.argmax(score))]
        if best not in out:
            out.append(best)
    return out


def reference_for(run) -> Reference:
    """The reference of the cell's configuration, on the kind of mesh its
    file names (``run.mesh``) at the cell's ``size_scale``."""
    return Reference(run.cfg, run.heating_csv,
                     size_scale=run.params.get("size_scale", 1.0),
                     vary=run.params["vary_material"], mesh=run.mesh)


def judge(run) -> dict:
    """{correct, attempted, failed, checks}: ``checks`` lists each number
    compared with its limit."""
    limits = run.params["limits"]
    attempted = sum(rec["watch"].shape[0] for rec in run.units)
    missing = sum(unanswered(rec) for rec in run.units)
    ic = float(run.cfg["heating"]["ic_temp"])
    t0 = time.perf_counter()
    ref = reference_for(run)
    readings: dict[str, float] = {}
    wrong = 0

    def note(one: dict) -> None:
        nonlocal wrong
        wrong += any(v > limits[k] for k, v in one.items() if k in limits)
        for k, v in one.items():
            if k in limits:
                readings[k] = max(readings.get(k, 0.0), v)

    picks = sample(run, int(run.params["check_samples"]),
                   run.params.get("check_hardest", ()))
    for u, j in picks:
        rec = run.units[u]
        want = ref.run(float(rec["kappa"][j]), float(rec["fwhm"][j]),
                       record="band" in rec)
        got = {k: rec[k][j] for k in ("watch", "band", "axis") if k in rec}
        one = gaps(got, want, ic)
        note(one)
        log(f"checked unit {u} lane {j} (kappa {float(rec['kappa'][j])!r}, "
            f"fwhm {float(rec['fwhm'][j])!r}): {one}")
    for u, rec in enumerate(run.units):
        st = rec.get("states")
        for c, j in enumerate(() if st is None else st["lanes"]):
            res = ref.step_residuals(float(rec["kappa"][j]),
                                     float(rec["fwhm"][j]), st["steps"],
                                     st["before"][:, c], st["after"][:, c])
            # a residual that is not a number reads as infinite
            res = [float(np.nan_to_num(r, nan=np.inf)) for r in res]
            note({"step_resid": max(res)})
            log(f"residual unit {u} lane {j} steps {st['steps'].tolist()}: "
                f"{res}")
    readings["unanswered"] = float(missing)
    checks = [dict(name=k, value=v, limit=limits[k])
              for k, v in readings.items()]
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    return dict(correct=all(c["value"] <= c["limit"] for c in checks),
                attempted=attempted, failed=missing + wrong, checks=checks)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
