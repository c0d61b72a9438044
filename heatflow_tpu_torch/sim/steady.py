"""Steady-state heat conduction solve and steady-as-initial-condition.

The reference exposes a steady form (unweighted: κ ∇u·∇v dx = f v dx,
ref space_and_forms.py:119-149) exercised by the with_gasket / with_ir_steady
notebooks, where the steady solution seeds the transient run. Here:

  * solve_steady — line-preconditioned CG on the per-material unweighted
    stiffness stencils with Dirichlet lifting, eager torch on the card (or
    the CPU when asked);
  * an axisymmetric (r-weighted) variant for physical consistency with the
    transient operator, selected by weighted=True.
"""

from __future__ import annotations

import numpy as np
import torch

from heatflow_tpu_torch.ops.cg import pcg
from heatflow_tpu_torch.ops.stencil import apply_stencil, material_combine
from heatflow_tpu_torch.sim.problem import Problem2D
from heatflow_tpu_torch.utils import resolve_device


def solve_steady(problem: Problem2D, bc_values: np.ndarray, *,
                 f=None, weighted: bool = False,
                 dtype: torch.dtype = torch.float64,
                 rtol: float = 1e-11, maxiter: int = 50000,
                 precondition: str = "adi", device="cuda"):
    """Solve Σ_m κ_m K_m u = f with Dirichlet data ``bc_values`` (full-grid
    array; only constrained entries are used) on ``device`` (the card unless
    the caller passes ``device='cpu'``; a missing card raises). Returns
    (u (Nz, Nr) ndarray, info dict).

    ``precondition``: 'adi' (default — steady solves are COLD, the regime
    where the split-additive r-line+z-line composition cuts iterations
    most), 'rline', 'zline', or 'jacobi'."""
    if precondition not in ("adi", "rline", "zline", "jacobi"):
        raise ValueError(f"unknown precondition {precondition!r}")
    device = resolve_device(device)
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    st = problem.stencils
    K = material_combine(t(problem.kappas),
                         t(st.K if weighted else st.K_flat))
    free = t(problem.free_mask)
    dirich = t(problem.dirichlet_mask)
    g = t(bc_values) * dirich

    diag = K[0]
    s = torch.rsqrt(torch.where(diag > 0, diag, torch.ones_like(diag))) \
        * free + dirich
    apply_s = lambda y: s * apply_stencil(K, s * y)

    pre = None
    if precondition == "adi":
        from heatflow_tpu_torch.ops.linesolve import adi_preconditioner
        pre = adi_preconditioner(K, s, free)
    elif precondition in ("rline", "zline"):
        from heatflow_tpu_torch.ops.linesolve import line_preconditioner
        pre = line_preconditioner(
            K, s, free, axis=-1 if precondition == "rline" else -2)

    with torch.no_grad():
        if f is None:
            b = torch.zeros_like(g)
        else:
            # consistent load: ∫ f φ dx via the unit mass
            M_unit = t(st.M if weighted else st.M_flat).sum(dim=0)
            b = apply_stencil(M_unit, t(f))
        b_lift = (b - apply_stencil(K, g)) * s * free
        sol = pcg(apply_s, b_lift, torch.zeros_like(g), mask=free, rtol=rtol,
                  maxiter=maxiter, precond=pre)
        u = sol.x * s * free + g
    return u.cpu().numpy(), {"iters": int(sol.iters),
                             "residual": float(sol.residual),
                             "converged": bool(sol.converged)}


def steady_heating_values(problem: Problem2D, t: float = 0.0,
                          amplitude: float | None = None) -> np.ndarray:
    """Boundary data for a steady solve: fixed edges at ic_temp, the heating
    line at the Gaussian profile with the given amplitude (defaults to the
    heating curve's value at time t) — the notebooks' workflow of holding the
    laser at a fixed level."""
    ic = problem.ic_temp
    if amplitude is None:
        off = problem.heating.amplitude_offset(ic)
        amplitude = float(np.interp(t, problem.heating.time,
                                    problem.heating.temp) - off)
    coeff = -4.0 * np.log(2.0) / problem.fwhm ** 2
    profile = np.exp(coeff * problem.r_sq) * problem.heat_mask
    return (ic * problem.dirichlet_mask.astype(float)
            + (amplitude - ic) * profile)
