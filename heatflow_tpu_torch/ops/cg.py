"""Preconditioned conjugate gradients, eager PyTorch.

Each backward-Euler step is an iterative solve against the matrix-free
stencil operator (ref: PETSc KSP + MUMPS LU, run_no_diamond.py:339-344).
Dirichlet rows are handled with a free-dof mask: the operator is applied to
the full field but residuals and updates are restricted to free dofs, which
keeps the restricted operator SPD.

Fields are (..., Nz, Nr); every leading dimension is an independent lane
with its own scalars, and a lane that has converged is frozen while the
others iterate (f32 CG driven past convergence goes unstable).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor        # iterations performed (per lane)
    residual: torch.Tensor     # final ||r||
    converged: torch.Tensor    # bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=(-2, -1))


def _lane(v: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar broadcast against (..., Nz, Nr) fields."""
    return v[..., None, None]


def refine_inner_scale(rn2: torch.Tensor, floor2: torch.Tensor, rtol,
                       dtype: torch.dtype):
    """Guard for the f64-residual refinement passes: given the squared f64
    residual norm ``rn2`` and the degenerate-rhs floor ``floor2``, return
    ``(rnorm, rtol_eff)`` for the f32 inner correction solve.

    The inner rhs is normalized to unit norm (CG is scale-invariant, so the
    rescale is exact): residual scales far below 1 would put the f32 stop
    target rtol²·‖b‖² into underflow. A lane at or below the floor gets
    ``rtol_eff = 2``, which stops the inner solve at its first check.
    Both results stay on the device (no host read)."""
    degen = rn2 <= floor2
    rnorm = torch.sqrt(torch.where(degen, torch.ones_like(rn2), rn2))
    rtol_eff = torch.where(degen, torch.full_like(rn2, 2.0),
                           torch.full_like(rn2, float(rtol))).to(dtype)
    return rnorm, rtol_eff


def pcg(apply_op: Callable[[torch.Tensor], torch.Tensor],
        b: torch.Tensor,
        x0: torch.Tensor,
        *,
        precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
        mask: torch.Tensor | None = None,
        rtol: float = 1e-10,
        atol: float = 0.0,
        maxiter: int = 2000,
        rtol_wrt: str = "b") -> CGResult:
    """Solve A x = b with preconditioned CG restricted to ``mask`` dofs.

    ``x0`` provides both the initial guess and the values of constrained dofs
    (they are preserved exactly in the output).

    rtol_wrt: 'b' stops at ||r|| <= rtol ||b||; 'r0' stops at
    ||r|| <= rtol ||r0|| (ties the tolerance to the increment scale of a
    warm-started time step).
    """
    msk = (torch.ones((), dtype=b.dtype, device=b.device) if mask is None
           else mask.to(b.dtype))
    pre = precond if precond is not None else (lambda r: r)

    bm = b * msk
    r = (bm - apply_op(x0) * msk) * msk
    z = pre(r) * msk
    p = z
    x = x0
    rz = _dot(r, z)
    rr2 = _dot(r, r)
    ref2 = rr2 if rtol_wrt == "r0" else _dot(bm, bm)
    stop2 = torch.clamp(rtol * rtol * ref2, min=atol * atol)
    k = torch.zeros(rr2.shape, dtype=torch.int32, device=b.device)

    while True:
        active = (k < maxiter) & (rr2 > stop2)
        if not bool(active.any()):
            break
        Ap = apply_op(p) * msk
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, torch.ones_like(pAp))
        x_n = x + _lane(alpha) * p
        r_n = r - _lane(alpha) * Ap
        z_n = pre(r_n) * msk
        rz_n = _dot(r_n, z_n)
        beta = rz_n / torch.where(rz != 0, rz, torch.ones_like(rz))
        p_n = z_n + _lane(beta) * p
        rr2_n = _dot(r_n, r_n)
        am = _lane(active)
        x, r, z, p = (torch.where(am, x_n, x), torch.where(am, r_n, r),
                      torch.where(am, z_n, z), torch.where(am, p_n, p))
        rz = torch.where(active, rz_n, rz)
        rr2 = torch.where(active, rr2_n, rr2)
        k = k + active.to(torch.int32)

    rnorm = torch.sqrt(_dot(r, r))
    # a non-finite residual stops the loop at its first check and would
    # return the finite seed as if converged: poison the solution instead
    x = torch.where(_lane(torch.isfinite(rnorm)), x,
                    torch.full_like(x, float("nan")))
    return CGResult(x=x, iters=k, residual=rnorm,
                    converged=_dot(r, r) <= stop2)


def pcg_fixed(apply_op: Callable[[torch.Tensor], torch.Tensor],
              b: torch.Tensor,
              x0: torch.Tensor,
              *,
              precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
              mask: torch.Tensor | None = None,
              iters: int = 50) -> CGResult:
    """Fixed-iteration PCG: ``iters`` iterations on every lane, no stop test
    and no freeze, with the guards of :func:`pcg` (pAp == 0 → 1,
    rz == 0 → 1). ``iters`` in the result is that count, per lane."""
    msk = (torch.ones((), dtype=b.dtype, device=b.device) if mask is None
           else mask.to(b.dtype))
    pre = precond if precond is not None else (lambda r: r)

    bm = b * msk
    r = (bm - apply_op(x0) * msk) * msk
    z = pre(r) * msk
    p = z
    x = x0
    rz = _dot(r, z)
    for _ in range(iters):
        Ap = apply_op(p) * msk
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, torch.ones_like(pAp))
        x = x + _lane(alpha) * p
        r = r - _lane(alpha) * Ap
        z = pre(r) * msk
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = z + _lane(beta) * p
        rz = rz_new
    rnorm = torch.sqrt(_dot(r, r))
    return CGResult(x=x, iters=torch.full(rnorm.shape, iters,
                                          dtype=torch.int32,
                                          device=b.device),
                    residual=rnorm,
                    converged=torch.ones(rnorm.shape, dtype=torch.bool,
                                         device=b.device))


def pcg_solve(*_args, **_kw):
    """Differentiable PCG through implicit differentiation (not ported
    yet)."""
    raise NotImplementedError("pcg_solve is not ported to heatflow_tpu_torch "
                              "yet (ROADMAP P7)")
