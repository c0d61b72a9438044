"""Preconditioned conjugate gradients, eager PyTorch.

Each backward-Euler step is an iterative solve against the matrix-free
stencil operator (ref: PETSc KSP + MUMPS LU, run_no_diamond.py:339-344).
Dirichlet rows are handled with a free-dof mask: the operator is applied to
the full field but residuals and updates are restricted to free dofs, which
keeps the restricted operator SPD.

Fields are (..., Nz, Nr); every leading dimension is an independent lane
with its own scalars, and a lane that has converged is frozen while the
others iterate (f32 CG driven past convergence goes unstable).
:func:`pcg_solve` (and, over the CUDA kernel, ``cuda_cg.cg_vmem_solve``)
differentiates a solve implicitly: one more solve for a gradient or a
tangent, instead of unrolling the iteration.
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


def refine_inner_seed(seed: torch.Tensor, rtol_eff: torch.Tensor
                      ) -> torch.Tensor:
    """Zero a carried inner-CG seed on degenerate refinement passes.

    The degenerate stop of :func:`refine_inner_scale` (``rtol_eff = 2``)
    only fires when the inner solve STARTS at the rhs residual, that is from
    a zero seed. A carried nonzero seed (``inner_seed='carry'``) puts ‖r0‖
    far above the target, and the solve would grind the roundoff-scale rhs
    to maxiter. ``rtol_eff`` is a scalar or one value per leading lane of
    ``seed``."""
    live = (rtol_eff < 1.0).to(seed.dtype)
    return seed * live.reshape(live.shape + (1,) * (seed.ndim - live.ndim))


def jacobi_preconditioner(diag: torch.Tensor, mask: torch.Tensor | None = None
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """M⁻¹ = 1/diag(A) on free dofs (the diagonal entries of constrained dofs
    are irrelevant; zeros are guarded)."""
    inv = 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag))
    if mask is not None:
        inv = inv * mask
    return lambda r: inv * r


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


class _LinearSolve(torch.autograd.Function):
    """One solve of a symmetric system: ``solve(rhs, direction, *operands)``.
    The operator's tensors come in as ``operands``, so that inside the
    Function they are plain tensors, their autograd and torch.func wrappers
    taken off (a solve may hand their pointers to a kernel). Used for the
    primal solve and for the adjoint and tangent solves of :class:`_Implicit`;
    never differentiated itself. Under ``torch.func.vmap`` a batch of
    right-hand sides is one call with the batch as leading lanes."""

    @staticmethod
    def forward(rhs, solve, direction, *operands):
        return solve(rhs, direction, *operands)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, rhs, solve, direction, *operands):
        if any(d is not None for d in in_dims[3:]):
            raise NotImplementedError("a batch of operators under vmap")
        rhs = rhs.movedim(in_dims[0], 0) if in_dims[0] is not None else \
            rhs.expand(info.batch_size, *rhs.shape)
        return solve(rhs, direction, *operands), 0


class _Implicit(torch.autograd.Function):
    """The derivative of x = A⁻¹ b by the implicit-function theorem, A
    symmetric. Its input is the residual r = b − A(θ)·x at the (detached)
    solution, whose derivative is db − dA·x; its value is 0, so x + this
    term is x exactly. Backward: λ = A⁻¹ g, one adjoint solve (autograd then
    carries −⟨λ, dA·x⟩ to θ and λ to b through the eager operator apply).
    Forward mode: A⁻¹ dr, one tangent solve."""

    @staticmethod
    def forward(r, solve, *operands):
        return torch.zeros_like(r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.solve = inputs[1]
        ctx.n_operands = len(inputs) - 2
        ctx.save_for_backward(*inputs[2:])
        ctx.save_for_forward(*inputs[2:])

    @staticmethod
    def backward(ctx, g):
        lam = _LinearSolve.apply(g, ctx.solve, "backward", *ctx.saved_tensors)
        return (lam, None) + (None,) * ctx.n_operands

    @staticmethod
    def jvp(ctx, dr, _solve, *_operands):
        return _LinearSolve.apply(dr, ctx.solve, "jvp", *ctx.saved_tensors)

    @staticmethod
    def vmap(info, in_dims, r, solve, *operands):
        return torch.zeros_like(r), in_dims[0]


def implicit_solve(solve, b: torch.Tensor, residual,
                   operands: tuple = ()) -> torch.Tensor:
    """x = A⁻¹ b, differentiable: ``solve(rhs, direction, *operands)`` solves
    the symmetric system for one right-hand side (with its seed rule) from
    the detached ``operands`` alone, and ``residual(x)`` is b − A(θ)·x with
    the live (differentiable) b and θ. The primal solve runs on the
    detached b; gradients and tangents enter through the residual at that
    solution."""
    x = _LinearSolve.apply(b.detach(), solve, "forward", *operands)
    return x + _Implicit.apply(residual(x), solve, *operands)


def pcg_solve(apply_op: Callable[..., torch.Tensor], b: torch.Tensor,
              x0: torch.Tensor, *, op_args: tuple = (),
              precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
              mask: torch.Tensor | None = None, rtol: float = 1e-10,
              atol: float = 0.0, maxiter: int = 2000,
              rtol_wrt: str = "b") -> torch.Tensor:
    """Differentiable PCG solve by implicit differentiation: ``apply_op(v,
    *op_args)`` is the (symmetric) operator, and gradients flow to ``b`` and
    to the tensors of ``op_args`` (not to ``x0``, nor to ``precond``, which
    only steer the solves). A backward pass costs one more :func:`pcg`
    solve (the adjoint system), a forward-mode tangent one more (the
    tangent system), instead of unrolling the iteration.

    Constrained dofs carry zeros in ``b`` and ``x0``. Every solve is seeded
    with c·x0, c = ⟨rhs, b⟩/⟨b, b⟩ per lane: exactly 1 for the primal solve
    (rhs is b, so the seed is x0 bitwise), ≈0 for the derivative solves,
    whose rhs is derivative-scale. Seeding those with the solution-scale x0
    would waste iterations burning down a huge initial residual, and under
    ``rtol_wrt='r0'`` it would set their stop target to rtol·‖A·x0‖, orders
    of magnitude above the tangent rhs, stopping them at once with corrupt
    gradients."""
    msk = (torch.ones((), dtype=b.dtype, device=b.device) if mask is None
           else mask.to(b.dtype))

    def solve(rhs, _direction, b_d, x0_d, msk, *args):
        bb = _dot(b_d, b_d)
        c = _dot(rhs, b_d) / torch.where(bb > 0, bb, torch.ones_like(bb))
        return pcg(lambda v: apply_op(v, *args) * msk, rhs, _lane(c) * x0_d,
                   precond=precond, mask=msk, rtol=rtol, atol=atol,
                   maxiter=maxiter, rtol_wrt=rtol_wrt).x

    operands = (b.detach(), x0.detach(), msk) + tuple(a.detach()
                                                       for a in op_args)
    return implicit_solve(solve, b,
                          lambda x: b - apply_op(x, *op_args) * msk,
                          operands)
