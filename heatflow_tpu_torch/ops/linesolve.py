"""Line (block-tridiagonal) preconditioning via parallel cyclic reduction.

The flagship operator's conditioning is dominated by the r-direction
coupling (fine radial grading near the heating axis), so r-line
block-Jacobi — one tridiagonal block per grid line, SPD as a principal
submatrix of an SPD operator — is a valid and strong CG preconditioner.

Each line is solved by parallel cyclic reduction (PCR): ceil(log2(N))
levels of uniform shifted multiply-adds. The backward-Euler operator is
constant across the transient, so the factorization runs once and only the
rhs phase runs per CG iteration:

    level k, stride s=2^k, unit-diagonal system  x_i + l_i x_{i-s} + u_i x_{i+s} = d_i:
        alpha_i = 1 - l_i u_{i-s} - u_i l_{i+s}
        l'  = -l_i l_{i-s} / alpha_i          (factor phase, once)
        u'  = -u_i u_{i+s} / alpha_i
        d'  = (d_i - l_i d_{i-s} - u_i d_{i+s}) / alpha_i   (rhs phase, per apply)
    after 2^K >= N every coupling leaves the domain and x = d.

The CG kernel's r-line (``ops/cuda_cg.py``) solves each line from its
Thomas factors instead (:func:`thomas_factor_lines`, three planes, once per
operand set): the forward and back substitutions of the LU factorization,
which a card runs as two scans along the line.
"""

from __future__ import annotations

import torch

from heatflow_tpu_torch.ops.stencil import shifted
from heatflow_tpu_torch.ops.tridiag import thomas_apply, thomas_factor


def _dim(axis: int) -> int:
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 (r) or -2 (z), got {axis}")
    return axis


def line_couplings(A: torch.Tensor, sf: torch.Tensor, axis: int, *,
                   Kv: torch.Tensor | None = None,
                   dk: torch.Tensor | None = None):
    """(l, u) couplings of the symmetrically scaled operator sf·A·sf along
    one grid axis, with boundary couplings zeroed.

    A: (..., 7|9, Nz, Nr) stencil (ops.stencil.OFFSETS order); sf: the
    scaling-with-free-mask vector s*free. axis=-1 is r (offsets 3/4),
    axis=-2 is z (offsets 1/2).

    With ``Kv`` and per-lane ``dk`` (B,) the operator of lane b is
    A + dk_b·Kv: only the two coupling planes are combined, per lane, so no
    (B, 7, Nz, Nr) operator is ever formed; ``sf`` is then (B, Nz, Nr).
    """
    up_k, lo_k = (3, 4) if _dim(axis) == -1 else (1, 2)
    a_up, a_lo = A[..., up_k, :, :], A[..., lo_k, :, :]
    if Kv is not None:
        dkl = dk[..., None, None]
        a_up = a_up + dkl * Kv[..., up_k, :, :]
        a_lo = a_lo + dkl * Kv[..., lo_k, :, :]
    u = sf * a_up * shifted(sf, 1, axis)   # couples i -> i+1
    l = sf * a_lo * shifted(sf, -1, axis)  # couples i -> i-1
    return l, u


def pcr_factor(l: torch.Tensor, u: torch.Tensor, axis: int = -1):
    """PCR factorization of unit-diagonal tridiagonal systems along ``axis``.

    Returns a list of (l_k, u_k, inv_alpha_k) per level; levels run until
    the stride covers the axis length.
    """
    n = l.shape[_dim(axis)]
    levels = []
    s = 1
    while s < n:
        alpha = 1.0 - l * shifted(u, -s, axis) - u * shifted(l, s, axis)
        inv_a = 1.0 / alpha
        l_new = -l * shifted(l, -s, axis) * inv_a
        u_new = -u * shifted(u, s, axis) * inv_a
        levels.append((l, u, inv_a))
        l, u = l_new, u_new
        s *= 2
    return levels


def pcr_apply(levels, d: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Solve the factored systems: K levels of shifted multiply-adds."""
    s = 1
    for l_k, u_k, inv_a in levels:
        d = (d - l_k * shifted(d, -s, axis) - u_k * shifted(d, s, axis)) \
            * inv_a
        s *= 2
    return d


def pcr_fold(levels, axis: int = -1):
    """Fold the per-level diagonal scales out of a PCR factorization.

    With g_k = ∏_{j<k} inv_a_j the coefficients rescale as
    l~_k = l_k · S₋(g_k) / g_k and u~_k = u_k · S₊(g_k) / g_k, and the apply
    becomes e' = e − l~_k e₋ − u~_k e₊ per level plus one final x = g_K · e:
    two factor planes per level and one diagonal plane. Returns
    ([(l~_k, u~_k), ...], g_K); g_K is None for a zero-level factorization.
    """
    if not levels:
        return [], None
    g = torch.ones_like(levels[0][0])
    out = []
    s = 1
    for l_k, u_k, inv_a in levels:
        gsafe = torch.where(g != 0, g, torch.ones_like(g))
        out.append((l_k * shifted(g, -s, axis) / gsafe,
                    u_k * shifted(g, s, axis) / gsafe))
        g = inv_a * g
        s *= 2
    return out, g


def pcr_apply_folded(levels2, g, d: torch.Tensor,
                     axis: int = -1) -> torch.Tensor:
    """Apply a folded factorization: K two-plane levels and one diagonal."""
    s = 1
    for l_k, u_k in levels2:
        d = d - l_k * shifted(d, -s, axis) - u_k * shifted(d, s, axis)
        s *= 2
    return d if g is None else g * d


def line_preconditioner(A: torch.Tensor, s: torch.Tensor, free: torch.Tensor,
                        axis: int = -1, *, Kv: torch.Tensor | None = None,
                        dk: torch.Tensor | None = None):
    """r-line (axis=-1) or z-line (axis=-2) block-Jacobi preconditioner for
    the scaled system (s·A·s) y = b: pre(r) = T⁻¹ r, T the line-tridiagonal
    part of s·A·s. The factorization runs here, once. ``Kv``/``dk``: the
    per-lane operators A + dk_b·Kv of a batch (see :func:`line_couplings`)."""
    l, u = line_couplings(A, s * free, axis, Kv=Kv, dk=dk)
    levels2, g = pcr_fold(pcr_factor(l, u, axis=axis), axis=axis)

    def pre(r):
        return pcr_apply_folded(levels2, g, r, axis=axis) * free

    return pre


def adi_preconditioner(A: torch.Tensor, s: torch.Tensor, free: torch.Tensor,
                       *, Kv: torch.Tensor | None = None,
                       dk: torch.Tensor | None = None):
    """Split-additive composition of both line solves on the scaled system:
    pre(r) = R r + Z r − r (the subtracted identity removes the doubly
    counted unit diagonal)."""
    R = line_preconditioner(A, s, free, axis=-1, Kv=Kv, dk=dk)
    Z = line_preconditioner(A, s, free, axis=-2, Kv=Kv, dk=dk)

    def pre(r):
        return R(r) + Z(r) - r * free

    return pre


def thomas_factor_lines(l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Thomas (LU) factors of the unit-diagonal tridiagonal systems
    x_i + l_i x_{i-1} + u_i x_{i+1} = d_i along the last axis (l_0 and
    u_{N-1} zero): the (3, ..., N) stack of the forward multipliers
    m_i = −l_i/den_{i−1}, the inverse pivots 1/den_i and cp_i = u_i/den_i,
    from :func:`~heatflow_tpu_torch.ops.tridiag.thomas_factor`'s pivots
    den_i = 1 − l_i·cp_{i−1} (den_{−1} = 1). The sweep runs in float64,
    each product and difference rounded alone, as the card's factor kernel
    runs it; the factors come back in the couplings' dtype. No pivoting:
    the systems are SPD (principal submatrices of an SPD operator)."""
    l64 = l.double()
    dl, den, cp = thomas_factor(
        torch.stack([torch.ones_like(l64), u.double(), l64], dim=-2))
    return torch.stack([-dl / _before(den), 1.0 / den, cp]).to(l.dtype)


def _before(den: torch.Tensor) -> torch.Tensor:
    """den_{i−1} along the last axis, with den_{−1} = 1."""
    return torch.cat([torch.ones_like(den[..., :1]), den[..., :-1]], dim=-1)


def thomas_apply_lines(F: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve with the factors of :func:`thomas_factor_lines` along the last
    axis, in d's dtype: :func:`~heatflow_tpu_torch.ops.tridiag.thomas_apply`
    on the factors read back as (l, den, cp), leading dimensions
    broadcasting. The sweeps run on the host, a step a line position (on a
    card each step would be a launch); the result comes back on d's
    device. The plain version of the card's row kernel: it is never
    differentiated, and takes and returns plain tensors."""
    m, inv, cp = F.detach().to(device="cpu", dtype=d.dtype)
    den = 1.0 / inv
    return thomas_apply((-m * _before(den), den, cp),
                        d.detach().cpu()).to(d.device)
