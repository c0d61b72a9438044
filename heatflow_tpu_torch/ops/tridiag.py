"""1D P1 assembly (3-point stencils) and a tridiagonal direct solver.

The reduced model's implicit systems are tridiagonal, so instead of an
iterative solve (or the reference's MUMPS LU, ref run_no_diamond_1d.py:602-607)
each step is an exact Thomas-algorithm solve: two sweeps, sequential over the
~10²-10³ axis nodes and vectorized over leading batch dimensions. The
operator and its Dirichlet rows do not change between the steps of a run, so
the elimination is factored once (:func:`thomas_factor`) and a step only
sweeps its right-hand side (:func:`thomas_apply`), each sweep in the order of
operations of the scalar recurrence.
"""

from __future__ import annotations

import numpy as np
import torch

from heatflow_tpu_torch.ops.stencil import material_combine


def assemble_1d(z: np.ndarray, cell_tags: np.ndarray, n_mats: int):
    """Per-material geometric 1D stencils.

    Returns dict with 'K' and 'M' of shape (n_mats, 3, Nz): index 0 is the
    diagonal, 1 the +1 off-diagonal (coupling to the right neighbor), 2 the
    -1 off-diagonal. 'M_unit' (3, Nz) is the unit-density mass used for
    source-term integration (ref run_no_diamond_1d.py:543).
    """
    z = np.asarray(z, dtype=np.float64)
    h = np.diff(z)                      # (Nz-1,)
    nz = len(z)
    K = np.zeros((n_mats, 3, nz))
    M = np.zeros((n_mats, 3, nz))
    for m in range(n_mats):
        w = (np.asarray(cell_tags) == m + 1).astype(np.float64)
        kh = w / h
        mh = w * h / 6.0
        # element [[1,-1],[-1,1]]/h and h/6 [[2,1],[1,2]] scattered to nodes
        K[m, 0, :-1] += kh
        K[m, 0, 1:] += kh
        K[m, 1, :-1] -= kh      # node i -> i+1
        K[m, 2, 1:] -= kh       # node i -> i-1
        M[m, 0, :-1] += 2.0 * mh
        M[m, 0, 1:] += 2.0 * mh
        M[m, 1, :-1] += mh
        M[m, 2, 1:] += mh
    return {"K": K, "M": M, "M_unit": M.sum(axis=0)}


def _shift_left(u: torch.Tensor) -> torch.Tensor:
    """out[..., i] = u[..., i+1], zero at the end."""
    return torch.cat([u[..., 1:], torch.zeros_like(u[..., :1])], dim=-1)


def _shift_right(u: torch.Tensor) -> torch.Tensor:
    """out[..., i] = u[..., i-1], zero at the start."""
    return torch.cat([torch.zeros_like(u[..., :1]), u[..., :-1]], dim=-1)


def apply_tridiag(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(A @ u) for a 3-point stencil C (..., 3, Nz), u (..., Nz)."""
    d, up, lo = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    return d * u + up * _shift_left(u) + lo * _shift_right(u)


def combine_tridiag(K, M, kappas, rho_cvs, dt):
    """(A, M_op) for a backward-Euler step, batched like combine_operator
    (unrolled multiply-add, not a matrix product — see
    stencil.material_combine)."""
    M_op = material_combine(rho_cvs, M)
    A = M_op + dt * material_combine(kappas, K)
    return A, M_op


def thomas_factor(C: torch.Tensor):
    """The part of the Thomas elimination that depends on the operator only:
    (dl, denom, cp), each (..., Nz), with denom_i = d_i − dl_i·cp_{i−1} and
    cp_i = du_i / denom_i."""
    d, du, dl = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    nz = d.shape[-1]
    cp_prev = torch.zeros_like(d[..., 0])
    denoms, cps = [], []
    for i in range(nz):
        denom = d[..., i] - dl[..., i] * cp_prev
        cp_prev = du[..., i] / denom
        denoms.append(denom)
        cps.append(cp_prev)
    return dl, torch.stack(denoms, dim=-1), torch.stack(cps, dim=-1)


def thomas_apply(factor, b: torch.Tensor) -> torch.Tensor:
    """Solve for one right-hand side b (..., Nz) with a factored operator:
    the forward sweep dp_i = (b_i − dl_i·dp_{i−1}) / denom_i, then the
    backward sweep x_i = dp_i − cp_i·x_{i+1}. Leading dimensions of the
    factor and of b broadcast."""
    dl, denom, cp = factor
    nz = b.shape[-1]
    dp_prev = torch.zeros(torch.broadcast_shapes(b.shape[:-1],
                                                 denom.shape[:-1]),
                          dtype=b.dtype, device=b.device)
    dps = []
    for i in range(nz):
        dp_prev = (b[..., i] - dl[..., i] * dp_prev) / denom[..., i]
        dps.append(dp_prev)
    x_next = torch.zeros_like(dp_prev)
    xs = [None] * nz
    for i in range(nz - 1, -1, -1):
        x_next = dps[i] - cp[..., i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def thomas_solve(C: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact tridiagonal solve A x = b with A as a 3-point stencil
    (..., 3, Nz) and b (..., Nz): factor and sweep; leading batch dimensions
    broadcast."""
    return thomas_apply(thomas_factor(C), b)


def dirichlet_operator(C: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The operator part of :func:`dirichlet_rows`: identity rows at the
    constrained nodes and zeroed columns touching them."""
    free = 1.0 - mask
    d = C[..., 0, :] * free + mask
    du = C[..., 1, :] * free * (1.0 - _shift_left(mask))
    dl = C[..., 2, :] * free * (1.0 - _shift_right(mask))
    return torch.stack([d, du, dl], dim=-2)


def dirichlet_rhs(C: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """The right-hand side part of :func:`dirichlet_rows`: the values at
    the constrained nodes, and their columns' contribution lifted out of
    the free rows."""
    free = 1.0 - mask
    du = C[..., 1, :] * free
    dl = C[..., 2, :] * free
    g = mask * values
    return torch.where(mask > 0, values,
                       b - du * _shift_left(g) - dl * _shift_right(g))


def dirichlet_rows(C: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                   values: torch.Tensor):
    """Impose Dirichlet rows by identity-row replacement (exact for a direct
    solve; equivalent to the reference's lifting + set_bc): the rows become
    identity rows, and the *columns* touching constrained nodes are zeroed
    with their contribution lifted into the rhs, which keeps the solve
    exactly equivalent. Returns (operator, rhs); the operator does not
    depend on b or on the values (:func:`dirichlet_operator`), so a run
    forms and factors it once and lifts each step's rhs
    (:func:`dirichlet_rhs`)."""
    return dirichlet_operator(C, mask), dirichlet_rhs(C, b, mask, values)
