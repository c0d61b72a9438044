"""z-semicoarsened two-level multigrid over the r-line smoother: the packing of
its operands and the plain V-cycle.

The preconditioner solves the strong r direction exactly per line and
coarsens only z. The coarse grid (every other z row, full r) is EMBEDDED: it
lives on the even rows of fine-shaped (Nz, Nr) planes, and the odd rows carry
identity rows. Every component of the V-cycle is then elementwise work plus
row and column shifts:

  restriction   rc = e_free*r + sh(pp*r, -1) + sh(pm*r, +1)
  coarse apply  9 shifted multiply-adds, z-offsets {0, +-2}, r {0, +-1}
  coarse line   exact tridiagonal solve along r of the scaled embedded
                operator, from its Thomas factors
  prolongation  x += e_free*xc + pm*sh(xc, -1) + pp*sh(xc, +1)

with pm/pp the linear-in-z interpolation weights (zero on even rows and on
Dirichlet fine rows), so restriction is exactly P^T and the V-cycle is
symmetric. The cycle itself runs in the ``cg_tol`` kernel
(``csrc/cg_tol.cu``, the mgz form) and in its plain version
(``ops/cuda_cg.py``).

The coarse operator is the Galerkin triple product P^T (S A S) P of the
SCALED masked fine operator, computed on the host with scipy once per
(problem, coefficients). It bakes the problem's default material
coefficients: a caller that overrides them at run time must not use
``precondition='mgz'`` (the stepper raises).
"""

from __future__ import annotations

import numpy as np
import torch

from heatflow_tpu_torch.ops.linesolve import (line_couplings,
                                              thomas_apply_lines,
                                              thomas_factor_lines)
from heatflow_tpu_torch.ops.stencil import (apply_stencil, shifted,
                                            stencil_to_coo)

# embedded coarse stencil plane order: (dz, dr) offsets in FINE index space
# (coarse z-offset 1 == fine 2)
MGZ_OFFSETS = [(0, 0), (2, 0), (-2, 0), (0, 1), (0, -1),
               (2, 1), (-2, -1), (2, -1), (-2, 1)]


def mgz_pack(A7: np.ndarray, s: np.ndarray, free: np.ndarray,
             dtype=np.float32) -> dict:
    """Build the embedded mgz operand dict for the ``cg_tol`` kernel.

    A7: (7, Nz, Nr) UNSCALED backward-Euler stencil (ops/stencil.OFFSETS
    order); s: the scaling vector (rsqrt(diag)*free + dirichlet); free: the
    free mask. Returns numpy arrays of ``dtype``:
      Ac9   (9, Nz, Nr)  embedded scaled coarse stencil (unit diagonal on
                         live even rows, identity odd/dead rows)
      pcrc  (3, Nz, Nr)  r-line Thomas factors of Ac9's tridiag part (the
                         r-line operand's layout: ops/linesolve.py:
                         thomas_factor_lines)
      aux   (4, Nz, Nr)  [sc, pm, pp, e_free]
    """
    import scipy.sparse as sp

    A7 = np.asarray(A7, np.float64)
    s = np.asarray(s, np.float64)
    free = np.asarray(free, np.float64)
    npts, nz, nr = A7.shape
    if npts != 7:
        raise ValueError("mgz_pack expects the 7-point structured stencil")
    n = nz * nr

    # scaled masked fine operator (identity Dirichlet rows): the system the
    # kernel's operator apply realizes
    rows, cols, vals = stencil_to_coo(A7)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    S = sp.diags((s * free).ravel())
    Ah = (S @ A @ S).tocsr()
    Ah = Ah + sp.diags((free.ravel() == 0).astype(np.float64))

    # prolongation: linear interpolation between every-other z rows,
    # identity in r, zero rows on Dirichlet fine nodes. Uniform 0.5 weights
    # in INDEX space are enough for a preconditioner-grade transfer (the
    # Galerkin product absorbs the grading), and keep pm + pp == 1 in f32.
    nzc = len(range(0, nz, 2))
    rows_p, cols_p, vals_p = [], [], []
    pm = np.zeros((nz, nr))
    pp = np.zeros((nz, nr))
    for i in range(nz):
        if i % 2 == 0:
            rows_p.append(i)
            cols_p.append(i // 2)
            vals_p.append(1.0)
        else:
            lo_j, hi_j = (i - 1) // 2, (i + 1) // 2
            if hi_j < nzc:
                rows_p += [i, i]
                cols_p += [lo_j, hi_j]
                vals_p += [0.5, 0.5]
                pm[i, :] = 0.5
                pp[i, :] = 0.5
            else:           # top odd row with no upper coarse neighbour
                rows_p.append(i)
                cols_p.append(lo_j)
                vals_p.append(1.0)
                pm[i, :] = 1.0
    Pz = sp.coo_matrix((vals_p, (rows_p, cols_p)), shape=(nz, nzc))
    P = (sp.diags(free.ravel())
         @ sp.kron(Pz, sp.eye(nr), format="csr")).tocsr()
    pm *= free
    pp *= free
    e_free = np.zeros((nz, nr))
    e_free[0::2, :] = 1.0
    e_free *= free

    # Galerkin coarse operator and its symmetric scaling (unit diagonal)
    Ac = (P.T @ Ah @ P).tocsr()
    dc = Ac.diagonal().copy()
    live = dc > 0
    sc_c = np.where(live, 1.0 / np.sqrt(np.where(live, dc, 1.0)), 0.0)
    Sc = sp.diags(sc_c)
    Ach = (Sc @ Ac @ Sc).tocsr()
    Ach = Ach + sp.diags((~live).astype(np.float64))

    # embed the scaled coarse stencil: coarse (j, ir) -> fine (2j, ir)
    Ac9 = np.zeros((9, nz, nr))
    Ac9[0][1::2, :] = 1.0            # identity odd rows
    coo = Ach.tocoo()
    jz_r, ir_r = np.divmod(coo.row, nr)
    jz_c, ir_c = np.divmod(coo.col, nr)
    dz = (jz_c - jz_r) * 2           # fine-index z offset
    dr = ir_c - ir_r
    for k, (oz, orr) in enumerate(MGZ_OFFSETS):
        sel = (dz == oz) & (dr == orr)
        Ac9[k][2 * jz_r[sel], ir_r[sel]] = coo.data[sel]

    # embedded coarse scaling plane (odd rows 1: inert)
    sc = np.ones((nz, nr))
    sc[0::2, :] = sc_c.reshape(nzc, nr)

    # r-line Thomas factors of the embedded coarse tridiagonal part, once,
    # in float64. Boundary couplings are zero by construction; odd rows
    # have zero couplings and unit diagonal, so their factors are those of
    # the identity.
    pcrc = thomas_factor_lines(torch.from_numpy(Ac9[4].copy()),
                               torch.from_numpy(Ac9[3].copy())).numpy()

    return {"Ac9": Ac9.astype(dtype), "pcrc": pcrc.astype(dtype),
            "aux": np.stack([sc, pm, pp, e_free]).astype(dtype)}


def coarse_apply(Ac9: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The embedded scaled coarse operator applied to y (Nz, Nr): the
    9-point stencil of :data:`MGZ_OFFSETS`, zeros outside the grid."""
    out = Ac9[0] * y
    for k, (oz, orr) in enumerate(MGZ_OFFSETS[1:], start=1):
        out = out + Ac9[k] * shifted(shifted(y, oz, -2), orr, -1)
    return out


def restrict(aux: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """sc · Pᵀ r1 on the embedded coarse rows (aux = [sc, pm, pp, e_free])."""
    sc, pm, pp, e_free = aux
    return sc * (e_free * r1 + shifted(pp * r1, -1, -2)
                 + shifted(pm * r1, 1, -2))


def prolong(aux: torch.Tensor, x: torch.Tensor, yc: torch.Tensor
            ) -> torch.Tensor:
    """x + P (sc · yc): the coarse correction interpolated onto the fine
    rows."""
    sc, pm, pp, e_free = aux
    xc = sc * yc
    return (x + e_free * xc + pm * shifted(xc, -1, -2)
            + pp * shifted(xc, 1, -2))


def mgz_reference_vcycle(A7, s, free, pack, *, omega=0.8, omega_c=0.8,
                         sweeps=2):
    """Float64 reference of the V-cycle (testing only): returns precond(r)
    on the SCALED system, from numpy in to numpy out, with the fine r-line
    factors built here from (A7, s, free)."""
    f64 = lambda v: torch.tensor(np.asarray(v, np.float64))
    A7, s, free = f64(A7), f64(s), f64(free)
    sf = s * free
    fine = thomas_factor_lines(*line_couplings(A7, sf, -1))
    line = lambda r: thomas_apply_lines(fine, r) * free
    # annihilated-Dirichlet convention, as the kernel's operator apply
    apply_h = lambda y: sf * apply_stencil(A7, sf * y)

    Ac9, pcrc, aux = f64(pack["Ac9"]), f64(pack["pcrc"]), f64(pack["aux"])
    line_c = lambda r: thomas_apply_lines(pcrc, r)

    def precond(r):
        r = f64(r)
        x = omega * line(r)
        rcs = restrict(aux, r - apply_h(x))
        yc = omega_c * line_c(rcs)
        for _ in range(sweeps - 1):
            yc = yc + omega_c * line_c(rcs - coarse_apply(Ac9, yc))
        x = prolong(aux, x, yc)
        x = x + omega * line(r - apply_h(x))
        return x.numpy()

    return precond
