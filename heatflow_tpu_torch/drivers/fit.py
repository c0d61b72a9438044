"""Gradient-based experimental fitting of (κ_sample, FWHM): the capability
the reference approximates with brute-force grid sweeps (ref
sweep_test.py, the 51-point κ scan minimizing o-side RMSE).

    python -m heatflow_tpu_torch.drivers.fit --config cfgs/X.yaml \
        --mesh-folder meshes/X --rebuild-mesh [--device cpu]

Every transient solve is differentiable (implicit differentiation: one
more solve a step for a gradient, one a step for each tangent), so the
normalized o-side RMSE has exact gradients in (κ, FWHM). Strategy:

  1. a coarse batched sweep over the search box (the batched solves);
  2. Adam in log-parameter space from the best starts, the starts advanced
     together, each start's step one forward and one adjoint transient;
  3. Gauss-Newton standard errors at the optimum from the residual
     Jacobian, in forward mode: one primal transient and two tangents.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from heatflow_tpu_torch.sim.problem import Problem2D
from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                normalized_oside_residuals,
                                                normalized_oside_rmse)
from heatflow_tpu_torch.utils import pad_to_multiple, resolve_device


@dataclass
class FitResult:
    k: float
    fwhm: float
    rmse: float
    history: list = field(default_factory=list)
    sweep_k: np.ndarray | None = None
    sweep_fwhm: np.ndarray | None = None
    sweep_rmse: np.ndarray | None = None
    k_stderr: float | None = None
    fwhm_stderr: float | None = None
    corr: float | None = None
    timings: dict = field(default_factory=dict)   # seconds per phase


def fit_uncertainty(objective, k: float, fwhm: float, *,
                    dtype: torch.dtype = torch.float64):
    """Gauss–Newton (Laplace) standard errors at a fitted optimum.

    The residual Jacobian J = ∂r/∂(κ, FWHM) is exact and taken in forward
    mode: ``torch.func.jvp`` vmapped over the two unit tangents, so the
    primal transient runs once. Each step's two tangent solves run as lanes
    of one eager pcg on the ``'xla'`` solver, and as one ``cg_tol`` solve
    each on ``'vmem'``. The parameter covariance is
    σ² (JᵀJ)⁺ with σ² = RSS/(N−2), the nonlinear least-squares error model
    (what scipy.curve_fit reports). Returns (k_stderr, fwhm_stderr,
    correlation)."""
    dev = getattr(objective, "device", torch.device("cpu"))
    theta = torch.tensor([k, fwhm], dtype=dtype, device=dev)
    res_fn = lambda th: objective.residuals(th[0], th[1])
    r, J = torch.func.vmap(
        lambda t: torch.func.jvp(res_fn, (theta,), (t,)),
        out_dims=(None, 0))(torch.eye(2, dtype=dtype, device=dev))
    r = r.detach().cpu().double().numpy()
    J = J.detach().cpu().double().numpy().T               # (N, 2)
    n, p = len(r), 2
    sigma2 = float(r @ r) / max(1, n - p)
    # pinv: a singular JᵀJ (a parameter pinned at a box bound, an
    # insensitive FWHM) degrades to large or zero errors, not a failed fit
    cov = sigma2 * np.linalg.pinv(J.T @ J)
    se = np.sqrt(np.maximum(np.diag(cov), 0.0))
    corr = float(cov[0, 1] / (se[0] * se[1])) if se.all() else 0.0
    return float(se[0]), float(se[1]), corr


def resolve_fit_solver(dtype, rtol, rtol_wrt, solver, precondition,
                       problem=None, *, device="cuda"):
    """The fit's solver stack, converging and fast per dtype and device.

    float64: rtol 1e-10 wrt ‖b‖ (the parity regime). float32: rtol 1e-5
    wrt the warm-start residual ('r0', increment-relative: the stopping
    rule that converges in float32 on DAC operators; 1e-5 keeps the
    objective's solve error below real fit minima).

    ``solver='auto'``: float32 on a CUDA device → 'vmem' (the K2 batch and
    the ``cg_tol`` kernel for the gradients) with 'rline'; float64 or the
    CPU → 'xla' with 'jacobi'. An explicit preconditioner the kernels lack
    ('mg', 'zline') resolves 'auto' to 'xla', as does an unstructured
    problem. Explicit settings pass through. Returns (rtol, rtol_wrt,
    solver, precondition)."""
    f64 = dtype == torch.float64
    if rtol is None:
        rtol = 1e-10 if f64 else 1e-5
    if rtol_wrt is None:
        rtol_wrt = "b" if f64 else "r0"
    if solver in (None, "auto"):
        solver = ("vmem" if not f64 and torch.device(device).type == "cuda"
                  and precondition not in ("mg", "zline")
                  and (problem is None or isinstance(problem, Problem2D))
                  else "xla")
    if precondition is None:
        precondition = "rline" if solver == "vmem" else "jacobi"
    return rtol, rtol_wrt, solver, precondition


def experimental_objective(problem, *, dtype: torch.dtype = torch.float64,
                           rtol: float | None = None, maxiter: int = 20000,
                           vary_material: str = "p_sample",
                           rtol_wrt: str | None = None, solver: str = "auto",
                           precondition: str | None = None, device="cuda"):
    """Return ``objective(k, fwhm)`` -> the normalized o-side RMSE against
    the problem's heating-curve 'oside' trace (the reference's fit metric,
    ref no_diamond.py:65-99), a 0-d tensor differentiable in both inputs;
    ``objective.batch(ks, fs)`` (B,) without autograd, and
    ``objective.residuals(k, fwhm)`` the per-point residuals. Solver
    settings default per dtype and device (:func:`resolve_fit_solver`).
    On the card unless ``device='cpu'``."""
    if not isinstance(problem, Problem2D):
        raise NotImplementedError("fits over unstructured problems are not "
                                  "ported to heatflow_tpu_torch yet "
                                  "(ROADMAP P9)")
    device = resolve_device(device)
    rtol, rtol_wrt, solver, precondition = resolve_fit_solver(
        dtype, rtol, rtol_wrt, solver, precondition, problem, device=device)
    heating = problem.heating
    if heating.oside is None:
        raise ValueError("heating curve lacks an 'oside' column to fit")
    ic = problem.ic_temp
    shifted = heating.oside - heating.oside[0] + ic
    exp_o = (shifted - shifted[0]) / (heating.temp.max() - heating.temp.min())
    exp_t = np.asarray(heating.time, float)

    warm = "extrapolate" if dtype == torch.float32 else "previous"
    # one maker serves the coarse batch and the gradients: on 'vmem' its
    # one_config runs the cg_tol kernel, on 'xla' the eager pcg_solve
    fn = make_sweep_fn(problem, vary_material=vary_material, dtype=dtype,
                       rtol=rtol, maxiter=maxiter, rtol_wrt=rtol_wrt,
                       solver=solver, precondition=precondition,
                       warm_start=warm, device=device)
    times = fn.times

    def objective(k, fwhm):
        return normalized_oside_rmse(times, fn.one_config(k, fwhm), exp_t,
                                     exp_o)

    objective.batch = lambda ks, fs: normalized_oside_rmse(
        times, fn(ks, fs), exp_t, exp_o)
    objective.residuals = lambda k, fwhm: normalized_oside_residuals(
        times, fn.one_config(k, fwhm), exp_t, exp_o)
    objective.device, objective.solver = device, solver
    objective.precondition = precondition
    return objective


def fit_parameters(problem, *, k_range=(1.0, 100.0),
                   fwhm_range=(1e-6, 1e-4), coarse=(8, 6), n_starts: int = 3,
                   adam_steps: int = 60, lr: float = 0.05,
                   dtype: torch.dtype = torch.float64,
                   rtol: float | None = None, verbose: bool = False,
                   coarse_chunk: int = 8, uncertainty: bool = True,
                   rtol_wrt: str | None = None, solver: str = "auto",
                   precondition: str | None = None, maxiter: int = 20000,
                   device="cuda") -> FitResult:
    """Coarse sweep + multi-start Adam refinement in log space (+ the
    Gauss-Newton errors). The coarse grid runs in batches of
    ``coarse_chunk`` configs (the last one padded); the starts are the
    ``n_starts`` best finite coarse points. Adam is ``torch.optim.Adam``
    with optax.adam's defaults (β = 0.9, 0.999, ε = 1e-8) on the clipped
    log-parameters; each loop step evaluates every start (value and
    gradient) before one update of all, and one more step than
    ``adam_steps`` evaluates the final iterate; the best iterate seen
    wins. On the card unless ``device='cpu'``."""
    obj = experimental_objective(problem, dtype=dtype, rtol=rtol,
                                 rtol_wrt=rtol_wrt, solver=solver,
                                 precondition=precondition, maxiter=maxiter,
                                 device=device)
    device = obj.device
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    t_start = time.time()
    ks = np.logspace(np.log10(k_range[0]), np.log10(k_range[1]), coarse[0])
    fs = np.logspace(np.log10(fwhm_range[0]), np.log10(fwhm_range[1]),
                     coarse[1])
    KK, FF = np.meshgrid(ks, fs, indexing="ij")
    flat_k, flat_f = KK.ravel(), FF.ravel()
    n_pts = len(flat_k)
    pk = pad_to_multiple(flat_k, coarse_chunk)
    pf = pad_to_multiple(flat_f, coarse_chunk)
    pieces = [obj.batch(pk[i:i + coarse_chunk], pf[i:i + coarse_chunk])
              .cpu().numpy() for i in range(0, len(pk), coarse_chunk)]
    sweep_rmse = np.concatenate(pieces)[:n_pts]
    order = np.argsort(np.where(np.isfinite(sweep_rmse), sweep_rmse, np.inf))
    starts = order[:n_starts]
    t_coarse = time.time() - t_start
    if verbose:
        print(f"coarse sweep best: rmse={sweep_rmse[starts[0]]:.5f} at "
              f"k={flat_k[starts[0]]:.3f}, fwhm={flat_f[starts[0]]:.3e} "
              f"({t_coarse:.1f}s)")

    lo_k, hi_k = np.log(k_range[0]), np.log(k_range[1])
    lo_f, hi_f = np.log(fwhm_range[0]), np.log(fwhm_range[1])

    as_t = lambda v: torch.tensor(v, dtype=dtype, device=device)

    def clip(x, lo, hi):
        # min(max(.)): half the gradient at a bound, as jnp.clip gives it
        # (the coarse grid's corners are starts exactly on the box)
        return torch.minimum(torch.maximum(x, as_t(lo)), as_t(hi))

    def loss(p):
        return obj(torch.exp(clip(p[0], lo_k, hi_k)),
                   torch.exp(clip(p[1], lo_f, hi_f)))

    params = torch.stack([torch.log(as_t(flat_k[starts])),
                          torch.log(as_t(flat_f[starts]))], dim=1)
    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    best_p = params.detach().cpu().numpy().copy()
    best_v = np.full(len(starts), np.inf)
    hist = []
    t_adam = time.time()
    for _step in range(adam_steps + 1):
        opt.zero_grad()
        v = []
        for i in range(len(starts)):
            val = loss(params[i])
            val.backward()
            v.append(float(val.detach()))
        v = np.asarray(v)
        hist.append(v)
        better = v < best_v
        best_p = np.where(better[:, None], params.detach().cpu().numpy(),
                          best_p)
        best_v = np.where(better, v, best_v)
        opt.step()
    sync()
    t_adam = time.time() - t_adam
    hist = np.stack(hist, axis=1)
    if verbose:
        print(f"adam refinement: {adam_steps + 1} steps in {t_adam:.1f}s")
    i = int(np.argmin(best_v))
    k_best = float(np.exp(np.clip(best_p[i, 0], lo_k, hi_k)))
    f_best = float(np.exp(np.clip(best_p[i, 1], lo_f, hi_f)))
    k_se = f_se = corr = None
    t_gn = time.time()
    if uncertainty:
        k_se, f_se, corr = fit_uncertainty(obj, k_best, f_best, dtype=dtype)
        if verbose:
            print(f"uncertainty (Gauss-Newton): k ± {k_se:.4f}, "
                  f"FWHM ± {f_se:.3e}, corr {corr:+.3f}")
    t_gn = time.time() - t_gn
    return FitResult(k=k_best, fwhm=f_best, rmse=float(best_v[i]),
                     history=hist.tolist(), sweep_k=flat_k,
                     sweep_fwhm=flat_f, sweep_rmse=sweep_rmse,
                     k_stderr=k_se, fwhm_stderr=f_se, corr=corr,
                     timings=dict(coarse_s=t_coarse, adam_s=t_adam,
                                  gauss_newton_s=t_gn))


def main(argv=None) -> FitResult:
    from heatflow_tpu_torch.config import load_config
    from heatflow_tpu_torch.drivers.run2d import _prepare_mesh, default_dtype
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.problem import build_problem

    p = argparse.ArgumentParser(
        description="Gradient-based (k, FWHM) experimental fit")
    p.add_argument("--config", required=True)
    p.add_argument("--mesh-folder", required=True)
    p.add_argument("--rebuild-mesh", action="store_true")
    p.add_argument("--k-range", type=float, nargs=2, default=[1.0, 100.0])
    p.add_argument("--fwhm-range", type=float, nargs=2,
                   default=[1e-6, 1e-4])
    p.add_argument("--adam-steps", type=int, default=60)
    p.add_argument("--rtol", type=float, default=None,
                   help="CG tolerance (default: per-dtype converging "
                        "setting: 1e-10 wrt b at f64, 1e-5 wrt r0 at f32)")
    p.add_argument("--solver", default="auto",
                   choices=["auto", "xla", "vmem"],
                   help="'vmem': the CUDA kernels (the batched sweep solve "
                        "and the differentiable cg_tol solve); 'xla': the "
                        "eager PyTorch PCG; 'auto' (default): the kernels "
                        "for float32 on a CUDA device, eager otherwise")
    p.add_argument("--precondition", default=None,
                   choices=["jacobi", "rline", "adi", "mg"],
                   help="CG preconditioner (default: rline on the kernels, "
                        "jacobi on the eager path; 'mg', the multigrid "
                        "V-cycle, runs on the eager path)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; fails when "
                        "there is no card; 'cpu' runs float64 and the plain "
                        "versions)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    mesh = _prepare_mesh(cfg, args.mesh_folder, args.rebuild_mesh, "auto")
    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    problem = build_problem(mesh, heating, cfg,
                            watcher_points=coupler_watcher_points(cfg))
    res = fit_parameters(problem, k_range=tuple(args.k_range),
                         fwhm_range=tuple(args.fwhm_range),
                         adam_steps=args.adam_steps,
                         dtype=default_dtype(device), rtol=args.rtol,
                         solver=args.solver, precondition=args.precondition,
                         verbose=True, device=device)
    print(f"BEST FIT: k = {res.k:.4f} W/m/K, FWHM = {res.fwhm:.4e} m, "
          f"o-side RMSE = {res.rmse:.6f}")
    if res.k_stderr is not None:
        print(f"          k = {res.k:.4f} ± {res.k_stderr:.4f} W/m/K, "
              f"FWHM = {res.fwhm:.4e} ± {res.fwhm_stderr:.3e} m "
              f"(1σ Gauss-Newton, corr {res.corr:+.3f})")
    return res


if __name__ == "__main__":
    main()
